"""Data-parallel train steps and one validation over N ranks (the
counterpart of ``__graft_entry__.dryrun_multichip``):

    python -m multi_modal_gnn_tpu_torch.tools.dryrun_dp --ranks 2 [--device cpu]
        [--parallel dp | 2d] [--model-parallel M] [--scale]

The tool starts the N ranks itself (``parallel/launch.py``), each on
``SyntheticSpec.tiny(seed=1)`` at hidden 32 (the RGCN on the segment path,
then with ``use_pallas`` on K1's per-shard plans), or with ``--scale`` on
the ``scale_100k`` graph at the default widths (``use_pallas`` only; the
parent builds the graph once and the ranks load it).  ``--parallel dp``
trains :class:`~multi_modal_gnn_tpu_torch.parallel.dp.DataParallelTrainer`
over N data ranks, ``2d`` :class:`~multi_modal_gnn_tpu_torch.parallel.dp2d.TwoDTrainer`
over ``N / M`` data by ``M`` model ranks.  Each rank takes one warm-up step
and 5 timed ones (host clock to a ``synchronize``), then validates.  On
the card (the default; it raises without one) rank ``r`` computes on card
``r % device_count``, over NCCL when each rank has a card of its own, else
gloo; ``--device cpu`` runs on the CPU.  Each run's losses must be finite
and agree across the ranks (``rtol 1e-5``: on the card the model axis's
replicas sum K1's atomics in their own orders).  Prints one JSON line per
run: the step ms (median of the 5), the collectives' calls, bytes and host
seconds a step (``parallel.collectives.stats``), each rank's
``torch.cuda.max_memory_allocated`` and K1 launches a step; exits 0.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

TIMED_STEPS = 5


def _config(scale: bool, use_pallas: bool, parallel: str, model_parallel: int):
    from multi_modal_gnn_tpu_torch.config import Config

    d = Config().to_dict()
    d["model"]["use_pallas"] = use_pallas
    if scale:
        d["graph"].update(dense_adjacency_max_bytes=0, src_span_rows=256)
    else:
        d["model"]["hidden_dim"] = 32
    d["train"]["extras"] = {"parallel": parallel, "model_parallel": model_parallel}
    return Config.from_dict(d)


def _graph(scale: bool, config, path: Optional[str]):
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph

    if path is not None:
        return torch.load(path, weights_only=False)
    spec = SyntheticSpec.scale_100k(seed=0) if scale else SyntheticSpec.tiny(seed=1)
    return make_synthetic_graph(spec, config, device="cpu")


def _rank(device: str, parallel: str, model_parallel: int, scale: bool, graph_path: Optional[str]) -> list:
    return [_run(device, parallel, model_parallel, scale, graph_path, use_pallas)
            for use_pallas in ((True,) if scale else (False, True))]


def _run(device: str, parallel: str, model_parallel: int, scale: bool, graph_path, use_pallas: bool) -> dict:
    from multi_modal_gnn_tpu_torch.graph.build import host_edges_of
    from multi_modal_gnn_tpu_torch.ops import segment_kernels
    from multi_modal_gnn_tpu_torch.parallel import collectives
    from multi_modal_gnn_tpu_torch.parallel.dp import DataParallelTrainer
    from multi_modal_gnn_tpu_torch.parallel.dp2d import TwoDTrainer
    from multi_modal_gnn_tpu_torch.parallel.mesh import init_2d_axes, init_axis
    from multi_modal_gnn_tpu_torch.training.masker import masker_from_config
    from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, resolve_device

    torch.set_num_threads(1)
    dev = resolve_device(None if device == "cuda" else device)
    cuda = dev.type == "cuda"
    if cuda:
        disable_tf32()
    cfg = _config(scale, use_pallas, parallel, model_parallel)
    graph = _graph(scale, cfg, graph_path)
    host_edges = host_edges_of(graph) if use_pallas else None
    masker = masker_from_config(cfg, graph)
    if parallel == "2d":
        mesh = init_2d_axes(dev, 0, model_parallel)
        trainer = TwoDTrainer(graph, masker, cfg, mesh=mesh, device=dev, host_edges=host_edges)
    else:
        trainer = DataParallelTrainer(graph, masker, cfg, axis=init_axis(dev), device=dev, host_edges=host_edges)
    step_ms = []
    for i in range(1 + TIMED_STEPS):
        if i == 1:  # the warm-up step is not counted
            collectives.reset_stats()
            segment_kernels.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_epoch()
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        trainer.epoch += 1
    per_step = {name: {k: v / TIMED_STEPS for k, v in s.items()} for name, s in collectives.stats.items()}
    k1 = segment_kernels.launch_counts["segment_sum_windowed"] / TIMED_STEPS
    val = trainer.validate("val")
    return {
        "rank": trainer.world.rank, "ranks": trainer.world.size, "backend": trainer.axis.backend or "none",
        "device": str(dev), "use_pallas": use_pallas, "train_loss": loss, "val_loss": val,
        "step_ms": statistics.median(step_ms[1:]), "warmup_ms": step_ms[0], "collectives_per_step": per_step,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if cuda else 0, "k1_launches": k1,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--parallel", choices=("dp", "2d"), default="dp")
    parser.add_argument("--model-parallel", type=int, default=2)
    parser.add_argument("--scale", action="store_true", help="the scale_100k graph at the default widths")
    args = parser.parse_args(argv)
    from multi_modal_gnn_tpu_torch.parallel.launch import run_ranks

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU dry run")
    model_parallel = args.model_parallel if args.parallel == "2d" else 1
    with tempfile.TemporaryDirectory(prefix="dryrun_dp_") as tmp:
        graph_path = None
        if args.scale:  # built once here; each rank loads it
            graph_path = str(Path(tmp) / "graph.pt")
            torch.save(_graph(True, _config(True, True, args.parallel, model_parallel), None), graph_path)
        per_rank = run_ranks(
            _rank, args.ranks, (args.device, args.parallel, model_parallel, args.scale, graph_path), timeout=1800
        )
    for out in zip(*per_rank):
        r0 = out[0]
        for r in out:
            finite = math.isfinite(r["train_loss"]) and math.isfinite(r["val_loss"])
            if not finite or not all(math.isclose(r[k], r0[k], rel_tol=1e-5) for k in ("train_loss", "val_loss")):
                raise SystemExit(f"dryrun_dp: ranks disagree or diverge: {out}")
        print(json.dumps({
            "dryrun_dp": "ok", "parallel": args.parallel, "ranks": r0["ranks"], "model_parallel": model_parallel,
            "scale": args.scale, "backend": r0["backend"], "use_pallas": r0["use_pallas"],
            "train_loss": r0["train_loss"], "val_loss": r0["val_loss"],
            "step_ms_per_rank": [r["step_ms"] for r in out], "warmup_ms_per_rank": [r["warmup_ms"] for r in out],
            "collectives_per_step": r0["collectives_per_step"],
            "max_memory_allocated_per_rank": [r["max_memory_allocated"] for r in out],
            "k1_launches_per_step_per_rank": [r["k1_launches"] for r in out],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
