"""Time every launch of K6 and K7 that fits, per attention group of the
``scale_100k`` HGT, in turns on one card, so that a launch shape can be
chosen from measurements.

    python -m multi_modal_gnn_tpu_torch.tools.attention_probe [--groups patient,lab] [--kernels fwd,dq] \
        [--widths 128,64] [--patients N]

Builds the ``scale_100k`` graph (seed 0, dense budget 0, span rows 256; with
``--patients``, that many patients in place of 100,000) and
its attention plans (the forward sides' tiles in row order, as the model
runs them), then for each group, each width ``h`` of ``--widths`` (4 heads)
and each kernel the launch at every slice width
:func:`~multi_modal_gnn_tpu_torch.ops.attention_kernels.rows_launch_at`
admits.  Each launch is first held
against the plain version (K6 out and LSE within ``1e-5 + 1e-5 |ref|``, K7
within ``1e-4 max |ref|``), then all are timed, each the median of 20
CUDA-event-timed calls, in the order of the list and then reversed; the mean
of a launch's two medians is printed beside it, the plan's own choice
marked.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import math
import statistics
from typing import Dict, List, Optional

import torch

REPS = 20


def _median_ms(fn, reps: int = REPS) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _close(got, want, kernel: str) -> bool:
    if kernel == "fwd":
        return all(bool(((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all()) for g, w in zip(got, want))
    return float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--groups", default="", help="comma-separated groups (default: all)")
    parser.add_argument("--kernels", default="fwd,dq", help="comma-separated: fwd (K6), dq (K7)")
    parser.add_argument("--widths", default="128", help="comma-separated widths h (4 heads each)")
    parser.add_argument("--patients", type=int, default=0, help="patients in place of scale_100k's")
    args = parser.parse_args(argv)

    import dataclasses

    from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
    from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
    from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E
    from multi_modal_gnn_tpu_torch.ops import attention_kernels as ak
    from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, require_cuda

    dev = require_cuda()
    disable_tf32()
    nh = 4
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0, src_span_rows=256),
        model=ModelConfig(use_pallas=True, architecture="HGT", num_heads=nh),
    )
    spec = SyntheticSpec.scale_100k(seed=0)
    if args.patients:
        spec = dataclasses.replace(spec, num_patients=args.patients)
    graph = ensure_attn_plans(make_synthetic_graph(spec, config, device="cpu"), config)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wanted = set(filter(None, args.groups.split(",")))
    results: Dict[str, dict] = {}
    for seed, (dst_t, plan) in enumerate(sorted(graph.attn_plans.items(), key=lambda kv: -kv[1].num_edges)):
        if wanted and dst_t not in wanted:
            continue
        plan = plan.to(dev)
        side = plan.fwd
        n, ns = plan.num_dst, plan.num_src_total
        fwd_args = (*side.arrays(), side.num_windows, nh)
        tiles = side.arrays()[1].shape[0] // TILE_E
        for d in (int(w) for w in args.widths.split(",")):
            gen = torch.Generator().manual_seed(20 + seed)
            q = (torch.randn(n, d, generator=gen) / math.sqrt(d // nh)).to(dev)
            k, v = (torch.randn(ns, d, generator=gen).to(dev) for _ in range(2))
            dout = torch.randn(n, d, generator=gen).to(dev)
            out_p, lse_p = ak.flash_attention_fwd_plain(q, k, v, *fwd_args)
            lse = lse_p[:n].contiguous()
            delta = (dout * out_p[:n]).reshape(n, nh, -1).sum(-1).contiguous()
            stats = (q, k, v, dout, lse, delta)
            want = {"fwd": (out_p[:n], lse_p[:n]), "dq": ak.flash_attention_dq_plain(*stats, *fwd_args)[:n]}
            calls = {
                "fwd": lambda launch: ak._fwd_on(launch, q, k, v, *fwd_args),
                "dq": lambda launch: ak._dq_on(launch, *stats, *fwd_args),
            }
            for kernel in args.kernels.split(","):
                planned = ak.rows_launch(kernel, tiles, d, nh, sms)
                variants = [ak.rows_launch_at(kernel, tiles, d, sms, width) for width in ak._head_slices(d, nh)]
                variants = [launch for launch in variants if launch is not None]
                for launch in variants:
                    got = calls[kernel](launch)
                    got = (got[0][:n], got[1][:n]) if kernel == "fwd" else got[:n]
                    torch.cuda.synchronize()
                    if not _close(got, want[kernel], kernel):
                        raise AssertionError(f"{kernel} {launch} on the {dst_t} group at h={d} disagrees with plain")
                order = list(range(len(variants)))
                times: Dict[int, List[float]] = {i: [] for i in order}
                for i in order + order[::-1]:
                    times[i].append(_median_ms(lambda: calls[kernel](variants[i])))
                print(f"{'K6' if kernel == 'fwd' else 'K7'} on the {dst_t} group at h={d} ({tiles} tiles, {ns} "
                      f"gathered rows), ms in turns (forward, then reversed):", flush=True)
                for i in order:
                    launch = variants[i]
                    mark = "  <- the plan" if launch == planned else ""
                    print(f"  {statistics.mean(times[i]):8.4f}  ({', '.join('%.4f' % t for t in times[i])})  "
                          f"slice {launch.slice:3d} grab {launch.grab} blocks {launch.blocks}{mark}", flush=True)
                results.setdefault(dst_t, {})[f"{kernel} h={d}"] = [
                    {"launch": variants[i], "planned": variants[i] == planned, "ms": times[i]} for i in order
                ]
            del q, k, v, dout, out_p, lse_p, stats, want, calls
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
