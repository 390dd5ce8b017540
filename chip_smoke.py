#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device   the card's name and power limit (nvidia-smi); TF32 off
  2. build    compile csrc/segment.cu for sm_90a
  3. graph    the scale_100k synthetic graph (seed 0, 100k patients, ~5M
              patient-lab edges), dense budget 0, span rows 256; per
              relation its aggregation tier, edges, windows and tiles
  4. kernels  each CUDA kernel against its plain PyTorch version at the
              graph's relation shapes: errors, tolerance, median times
  5. slice    the RGCN at full width (hidden 128, 2 layers, heads (64, 32),
              float32, seeded weights): compute_node_state with the kernels
              on the GPU against the plain versions on the CPU
  6. requests build_serving_fn, three 500-lab patient requests and batches
              of 256 and 4096 pairs, held against the plain state's answers
Then a JSON line of per-kernel results, the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the last line; without a CUDA device it fails in phase 1.
"""

from __future__ import annotations

import copy
import json
import statistics
import sys
import time

# mean aggregations of f32 sums whose order differs (atomics vs index_add_)
KERNEL_ATOL, KERNEL_RTOL = 1e-5, 1e-5
# the whole forward: f32 on the GPU against f32 on the CPU
SLICE_ATOL, SLICE_RTOL = 1e-4, 1e-4
TIMING_REPS = 20

KERNEL_SOURCE = "multi_modal_gnn_tpu_torch/csrc/segment.cu"
REPLACES = {
    "segment_sum_windowed": "multi_modal_gnn_tpu/ops/pallas_segment.py:117",
    "fused_table_segment_sum": "multi_modal_gnn_tpu/ops/pallas_segment.py:279",
    "span_segment_sum": "multi_modal_gnn_tpu/ops/pallas_segment.py:529",
}


def _phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {time.perf_counter() - t0:.3f} s  {msg}", flush=True)


def _median_ms(fn, reps: int = TIMING_REPS) -> float:
    import torch

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


def _compare(name: str, got, want, atol: float, rtol: float) -> tuple:
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = float((diff / want.abs().clamp_min(1e-12)).max()) if diff.numel() else 0.0
    ok = bool((diff <= atol + rtol * want.abs()).all())
    print(
        f"    {name}: max_abs_err {max_abs:.3e}  max_rel_err {max_rel:.3e}  "
        f"tolerance |d| <= {atol:g} + {rtol:g}|ref|  {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError(f"{name}: outside tolerance")
    return max_abs, max_rel


def main() -> int:
    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
    from multi_modal_gnn_tpu_torch.graph.hetero import SPAN_MIN_SRC, TILE_E, WINDOW
    from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, mirror_edge_type
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.ops import _build, aggregation_tier
    from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
    from multi_modal_gnn_tpu_torch.serving import (
        build_serving_fn,
        compute_node_state,
        predict_patient,
    )
    from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, gpu_identity, require_cuda

    # 1. device ------------------------------------------------------------
    t0 = time.perf_counter()
    dev = require_cuda()
    identity = gpu_identity()
    disable_tf32()
    print(identity, flush=True)
    _phase(
        "device", t0,
        f"{torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}  "
        f"torch {torch.__version__}  cuda {torch.version.cuda}",
    )

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    report = [
        ln.strip() for ln in _build.build_log.splitlines()
        if any(w in ln for w in ("Compiling", "registers", "spill"))
    ]
    for ln in report:
        print(f"    ptxas: {ln}")
    _phase("build", t0, f"built and loaded {_build.build().name}")

    # 3. graph -------------------------------------------------------------
    t0 = time.perf_counter()
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0, src_span_rows=256),
        model=ModelConfig(use_pallas=True),
    )
    d = config.model.hidden_dim
    graph_cpu = make_synthetic_graph(SyntheticSpec.scale_100k(seed=0), config)
    graph = graph_cpu.to(dev)
    tiers = {}
    for et, es in graph.edges.items():
        tier = aggregation_tier(es, graph.edges.get(mirror_edge_type(et)), d)
        tiers[et] = tier
        tiles = (es.span_local if tier == "span" else es.win_local).shape[0] // TILE_E
        span = ""
        if es.num_src >= SPAN_MIN_SRC:
            span = "  span plan: " + (
                f"built, {es.span_local.shape[0]} slots vs {es.win_local.shape[0]} windowed"
                if es.span_rows else "refused by the inflation guard"
            )
        print(
            f"    {'/'.join(et)}: tier {tier}  E {es.num_valid}  windows {es.num_windows}  "
            f"tiles {tiles}{span}"
        )
    _phase("graph", t0, f"node counts {dict(graph.node_counts)}")

    # 4. kernels -----------------------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)

    def pick(tier_names):
        cands = [et for et, t in tiers.items() if t in tier_names]
        if not cands:
            raise AssertionError(f"no relation takes tier {tier_names}")
        return max(cands, key=lambda et: graph.edges[et].num_valid)

    def mean_of(total, es):
        return total[: es.num_dst] / es.dst_count.clamp_min(1.0)[:, None]

    results = {}

    def check(name, et, kernel, plain):
        es = graph.edges[et]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        max_abs, _ = _compare(f"{name} on {'/'.join(et)}", mean_of(got, es), mean_of(want, es),
                              KERNEL_ATOL, KERNEL_RTOL)
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        print(f"    {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  (median of {TIMING_REPS})")
        results[name] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}

    et1 = pick(("paired", "windowed"))
    es1 = graph.edges[et1]
    x1 = torch.randn(es1.num_src, d, generator=gen).to(dev)
    check(
        "segment_sum_windowed", et1,
        lambda: sk.segment_sum_windowed(x1, es1.win_src, es1.win_local, es1.win_tile_map, es1.num_windows),
        lambda: sk.segment_sum_windowed_plain(x1, es1.win_src, es1.win_local, es1.win_tile_map, es1.num_windows),
    )
    g1 = x1.index_select(0, es1.win_src.long())  # pre-gathered rows (idx=None)
    _compare(
        "segment_sum_windowed(idx=None)",
        mean_of(sk.segment_sum_windowed(g1, None, es1.win_local, es1.win_tile_map, es1.num_windows), es1),
        mean_of(sk.segment_sum_windowed_plain(g1, None, es1.win_local, es1.win_tile_map, es1.num_windows), es1),
        KERNEL_ATOL, KERNEL_RTOL,
    )

    et2 = pick(("fused_table",))
    es2 = graph.edges[et2]
    x2 = torch.randn(es2.num_src, d, generator=gen).to(dev)
    check(
        "fused_table_segment_sum", et2,
        lambda: sk.fused_table_segment_sum(x2, es2.win_src, es2.win_local, es2.win_tile_map, es2.num_windows),
        lambda: sk.fused_table_segment_sum_plain(x2, es2.win_src, es2.win_local, es2.win_tile_map, es2.num_windows),
    )

    et3 = pick(("span",))
    es3 = graph.edges[et3]
    x3 = torch.randn(es3.num_src, d, generator=gen).to(dev)
    span_args = (es3.span_src, es3.span_local, es3.span_tile_map, es3.span_base, es3.num_windows, es3.span_rows)
    check(
        "span_segment_sum", et3,
        lambda: sk.span_segment_sum(x3, *span_args),
        lambda: sk.span_segment_sum_plain(x3, *span_args),
    )
    rows_pad = max(-(-es3.num_src // WINDOW) * WINDOW, es3.span_rows)
    if rows_pad == es3.num_src:
        rows_pad += es3.span_rows  # keep NaN rows past the table for the check
    x3_nan = torch.full((rows_pad, d), float("nan"), device=dev)
    x3_nan[: es3.num_src] = x3
    _compare(
        f"span_segment_sum, {rows_pad - es3.num_src} NaN rows past the table",
        mean_of(sk.span_segment_sum(x3_nan, *span_args), es3),
        mean_of(sk.span_segment_sum_plain(x3, *span_args), es3),
        KERNEL_ATOL, KERNEL_RTOL,
    )
    _phase("kernels", t0, "K1, K2f, K3 match their plain versions")

    # 5. slice -------------------------------------------------------------
    t0 = time.perf_counter()
    model = build_model(config, graph_cpu, generator=torch.Generator().manual_seed(0))
    model_cpu = copy.deepcopy(model)
    model.to(dev)
    sk.reset_launch_counts()
    t_state = time.perf_counter()
    state = compute_node_state(model, graph)
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t_state
    after_state = dict(sk.launch_counts)
    if not all(after_state.values()):
        raise AssertionError(f"a kernel of the path did not launch: {after_state}")
    state_plain = compute_node_state(model_cpu, graph_cpu)
    for key in ("init_p", "init_l", "final_p", "final_l", "degree"):
        _compare(f"state[{key}]", state[key], state_plain[key], SLICE_ATOL, SLICE_RTOL)
    _phase(
        "slice", t0,
        f"head_style {model.head_style}  compute_node_state (first call) {state_s * 1e3:.1f} ms  "
        f"launches {after_state}",
    )

    # 6. requests ----------------------------------------------------------
    t0 = time.perf_counter()
    fn, _ = build_serving_fn(model, graph, state)
    fn_plain, _ = build_serving_fn(model_cpu, graph_cpu, state_plain)
    rng = np.random.default_rng(0)
    num_p, num_l = graph.num_nodes(PATIENT), graph.num_nodes(LAB)
    requests = [("patient", int(p)) for p in rng.integers(0, num_p, 3)] + [
        ("pairs", (rng.integers(0, num_p, n), rng.integers(0, num_l, n))) for n in (256, 4096)
    ]

    def answer(f, req):
        kind, arg = req
        return predict_patient(f, arg, num_l) if kind == "patient" else f(*arg)

    latencies = []
    for req in requests:
        t_req = time.perf_counter()
        out = answer(fn, req)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t_req)
        _compare(f"request {req[0]} ({out.shape[0]} pairs)", out, answer(fn_plain, req), SLICE_ATOL, SLICE_RTOL)
    launches = dict(sk.launch_counts)  # the main path ends here
    _phase(
        "requests", t0,
        f"{len(requests)} requests  p50 latency {statistics.median(latencies) * 1e3:.3f} ms "
        f"(first pass, host clock to synchronize)",
    )

    # steady-state times after the checked run
    warm = []
    for _ in range(5):
        t_state = time.perf_counter()
        compute_node_state(model, graph)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t_state)
    steady = {}
    for req in requests:
        lat = []
        for _ in range(TIMING_REPS):
            t_req = time.perf_counter()
            answer(fn, req)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t_req)
        steady.setdefault(req[0], []).extend(lat)
    print(
        f"    steady state: compute_node_state median {statistics.median(warm) * 1e3:.2f} ms "
        f"(5 runs); request p50 " + ", ".join(
            f"{k} {statistics.median(v) * 1e3:.3f} ms" for k, v in steady.items()
        ) + f" ({TIMING_REPS} runs each)"
    )

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            **results[name],
        }
        for name in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(identity)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
