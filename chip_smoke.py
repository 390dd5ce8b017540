#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device        the card's name and power limit (nvidia-smi); TF32 off
  2. build         compile csrc/*.cu for sm_90a, one nvcc per source
  3. graph         the scale_100k synthetic graph (seed 0, 100k patients, ~5M
                   patient-lab edges), dense budget 0, span rows 256; per
                   relation its aggregation tier, edges, windows and tiles
  4. kernels       K1, K2f, K3 against their plain PyTorch versions at the
                   graph's relation shapes: errors, tolerance, median times
  5. slice         the RGCN at full width (hidden 128, 2 layers, heads (64,
                   32), float32, seeded weights): compute_node_state with the
                   kernels on the GPU against the plain versions on the CPU
  6. requests      build_serving_fn, three 500-lab patient requests and
                   batches of 256 and 4096 pairs, held against the plain
                   state's answers
  7. train-kernels the slot-major span@256 train batch (split seed 42); K2b on
                   the three fused-table relations, K1 as the span tier's
                   backward, K4f and K4b (dropout 0 and 0.2, both heads' tile
                   masks) against their plain versions at these shapes
  8. train-step    one Adam step with dropout 0 on the card against the same
                   step with the plain versions on the CPU: loss, every
                   gradient, the parameters and the BatchNorm statistics;
                   every kernel of the path launched
  9. train         5 epochs with dropout 0.2 on the card (the training path's
                   launch counts), the median epoch time, the bench's
                   train_patient_lab_edges_per_sec, a validation loss, and
                   one torch.profiler epoch: top device kernels, idle share
Then a JSON line of per-kernel results, the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the last line; without a CUDA device it fails in phase 1.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import sys
import time

# mean aggregations of f32 sums whose order differs (atomics vs index_add_)
KERNEL_ATOL, KERNEL_RTOL = 1e-5, 1e-5
# the whole forward: f32 on the GPU against f32 on the CPU
SLICE_ATOL, SLICE_RTOL = 1e-4, 1e-4
# pair-head outputs: sums of 64 and 32 f32 products in another order
HEAD_ATOL, HEAD_RTOL = 1e-5, 1e-5
# gradients that sum up to ~3.5M f32 terms with atomics: the error of such a
# sum is ~sqrt(n) * 6e-8 ~ 1e-4 of the largest partial sums, so each tensor
# of a kernel's backward is held to 1e-4 of its largest magnitude
GRAD_REL = 1e-4
# the pair head's kernel and plain version sum h0 @ W1 in other orders, so a
# layer-1 unit within that rounding (< 1e-4 at these magnitudes) of 0 may
# take the other side of the ReLU: the kernel checks give slots with such a
# unit no upstream gradient
KINK_MARGIN = 1e-3
# A whole step's gradients, card against CPU, per tensor in the 2-norm.  The
# heads' gradients agree to ~1e-4; upstream of the GNN's ReLUs and
# BatchNorms they drift to ~1e-2 (embed_patient 9.98e-3; NVIDIA H100 80GB
# HBM3, 700.00 W): a unit whose pre-activation lies within the two sides'
# rounding of 0 takes the other side of its ReLU and moves a node's
# gradient row by a whole term, and BatchNorm's backward subtracts means
# that nearly cancel.  A fault of the path (a relation's gradient dropped,
# misscaled or sent through the wrong plan) moves whole terms of a tensor.
# So each tensor is held to 3e-2 of its norm, three times the drift, plus
# 1e-6 of the step's largest gradient norm for the gradients that are
# exactly 0 (a bias feeding a BatchNorm), which both sides produce as
# rounding noise.
STEP_GRAD_NORM_REL, STEP_GRAD_ZERO_FLOOR = 3e-2, 1e-6
# Adam's first step moves a parameter by ~lr * sign(grad): a near-zero
# gradient whose sign the reordered sums flip moves it by up to 2 * lr
STEP_PARAM_ATOL = 2e-3
# BatchNorm statistics: f32 means over up to 100k rows
STEP_BN_ATOL, STEP_BN_RTOL = 1e-4, 1e-4
STEP_LOSS_RTOL = 1e-5
TIMING_REPS = 20
TRAIN_EPOCHS = 5
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores; TF32 is off
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

SEGMENT_SOURCE = "multi_modal_gnn_tpu_torch/csrc/segment.cu"
PAIRHEAD_SOURCE = "multi_modal_gnn_tpu_torch/csrc/pairhead.cu"
KERNELS = {  # wrapper: (source, the TPU kernel it replaces)
    "segment_sum_windowed": (SEGMENT_SOURCE, "multi_modal_gnn_tpu/ops/pallas_segment.py:117"),
    "fused_table_segment_sum": (SEGMENT_SOURCE, "multi_modal_gnn_tpu/ops/pallas_segment.py:279"),
    "fused_table_segment_sum_bwd": (SEGMENT_SOURCE, "multi_modal_gnn_tpu/ops/pallas_segment.py:357"),
    "span_segment_sum": (SEGMENT_SOURCE, "multi_modal_gnn_tpu/ops/pallas_segment.py:529"),
    "pair_head_fwd": (PAIRHEAD_SOURCE, "multi_modal_gnn_tpu/ops/pallas_pairhead.py:296"),
    "pair_head_bwd": (PAIRHEAD_SOURCE, "multi_modal_gnn_tpu/ops/pallas_pairhead.py:362"),
}
# FLOPs per active slot: pre0 adds (64), h0 @ W1 (2 * 64 * 32), b1 (32),
# h1 . w2 (2 * 32); the backward adds dw2 (64), dpre1 @ W1^T and the dW1
# outer products (2 * 2 * 64 * 32) and the dPp / dPl scatters (2 * 64)
HEAD_FWD_FLOPS = 64 + 2 * 64 * 32 + 32 + 2 * 32
HEAD_BWD_FLOPS = HEAD_FWD_FLOPS + 64 + 2 * 2 * 64 * 32 + 2 * 64


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


def _compare_scaled(name: str, got, want, rel: float) -> float:
    """``max |got - want| <= rel * max |want|`` over the tensor."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    max_abs = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    ok = max_abs <= rel * scale or max_abs == 0.0
    print(
        f"    {name}: max_abs_err {max_abs:.3e}  max|ref| {scale:.3e}  "
        f"tolerance {rel:g} * max|ref|  {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError(f"{name}: outside tolerance")
    return max_abs


def _compare_norm(name: str, got, want, rel: float, floor: float = 0.0) -> bool:
    """``||got - want||_2 <= rel * ||want||_2 + floor`` over the tensor."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err, norm = float(torch.linalg.vector_norm(got - want)), float(torch.linalg.vector_norm(want))
    max_abs = float((got - want).abs().max()) if got.numel() else 0.0
    max_ref = float(want.abs().max()) if got.numel() else 0.0
    ok = err <= rel * norm + floor
    print(
        f"    {name}: ||d|| / ||ref|| {err / max(norm, 1e-300):.3e}  ||ref|| {norm:.3e}  "
        f"max_abs_err {max_abs:.3e}  max|ref| {max_ref:.3e}  tolerance {rel:g} ||ref|| + {floor:.2e}  "
        f"{'ok' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes: int, flops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    FLOPs over the float32 peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _library_ms(name: str, fn):
    """Time one PyTorch call computing the same function (the yardstick,
    used nowhere in the port); None where the call is not supported."""
    try:
        ms = _median_ms(fn)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"    {name}: library call not timed ({type(exc).__name__}: {exc})")
        return None
    print(f"    {name}: library call {ms:.4f} ms")
    return ms


def _csr(row_ptr, cols, num_rows, num_cols, device):
    """The 0/1 sparse matrix [num_rows, num_cols] of a dst-sorted relation
    (rows = destinations), for torch.sparse.mm."""
    import torch

    n = int(row_ptr[-1])
    return torch.sparse_csr_tensor(
        row_ptr.long().to(device), cols[:n].long().to(device),
        torch.ones(n, dtype=torch.float32, device=device), size=(num_rows, num_cols),
    )


def _device_profile(fn) -> tuple:
    """(wall ms, busy ms, [(kernel, ms)]) of one call under torch.profiler,
    after one profiled call that pays the tracer's start-up; busy is the
    summed duration of the device kernels it ran (one stream, so they do not
    overlap).  Ranges the host marks on the device timeline (the optimizer's
    ``record_function`` labels) carry host event names and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    host_names = {evt.name for evt in prof.events() if evt.device_type == DeviceType.CPU}
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and evt.name not in host_names:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return wall_ms, sum(by_name.values()), top


def main() -> int:
    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
    from multi_modal_gnn_tpu_torch.graph.hetero import SPAN_MIN_SRC, TILE_E, WINDOW
    from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB, mirror_edge_type
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.ops import _build, aggregation_tier
    from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
    from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
    from multi_modal_gnn_tpu_torch.serving import (
        build_serving_fn,
        compute_node_state,
        predict_patient,
    )
    from multi_modal_gnn_tpu_torch.training import Trainer, masker_from_config
    from multi_modal_gnn_tpu_torch.training.masker import _pad_batch
    from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, gpu_identity, require_cuda

    def reset_counts():
        sk.reset_launch_counts()
        pk.reset_launch_counts()

    def read_counts():
        return {**sk.launch_counts, **pk.launch_counts}

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
        if any(w in ln for w in ("==", "Compiling", "registers", "spill"))
    ]
    for ln in report:
        print(f"    ptxas: {ln}")
    _phase("build", t0, f"built and loaded {_build.build().name} from {len(_build.SOURCES)} sources")

    # 3. graph -------------------------------------------------------------
    t0 = time.perf_counter()
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0, src_span_rows=256),
        model=ModelConfig(use_pallas=True),
    )
    d = config.model.hidden_dim
    graph_cpu = make_synthetic_graph(SyntheticSpec.scale_100k(seed=0), config, device="cpu")
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

    def timed(name, kernel, plain, library, nbytes, flops, max_abs):
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        bound = _bound(nbytes, flops)
        print(
            f"    {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  (median of {TIMING_REPS})  "
            f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})"
        )
        results[name] = {
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None if library is None else _library_ms(name, library),
        }

    def check(name, et, x, kernel, plain, library, plan_tensors):
        es = graph.edges[et]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        max_abs, _ = _compare(f"{name} on {'/'.join(et)}", mean_of(got, es), mean_of(want, es),
                              KERNEL_ATOL, KERNEL_RTOL)
        nbytes = _nbytes(x, *plan_tensors) + es.num_windows * WINDOW * x.shape[1] * 4
        timed(name, kernel, plain, library, nbytes, es.num_valid * x.shape[1], max_abs)

    et1 = pick(("paired", "windowed"))
    es1 = graph.edges[et1]
    x1 = torch.randn(es1.num_src, d, generator=gen).to(dev)
    csr1 = _csr(es1.row_ptr, es1.src, es1.num_dst, es1.num_src, dev)
    check(
        "segment_sum_windowed", et1, x1,
        lambda: sk.segment_sum_windowed(x1, es1.win_src, es1.win_local, es1.win_tile_map, es1.num_windows),
        lambda: sk.segment_sum_windowed_plain(x1, es1.win_src, es1.win_local, es1.win_tile_map, es1.num_windows),
        lambda: torch.sparse.mm(csr1, x1),
        (es1.win_src, es1.win_local, es1.win_tile_map),
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
    csr2 = _csr(es2.row_ptr, es2.src, es2.num_dst, es2.num_src, dev)
    check(
        "fused_table_segment_sum", et2, x2,
        lambda: sk.fused_table_segment_sum(x2, es2.win_src, es2.win_local, es2.win_tile_map, es2.num_windows),
        lambda: sk.fused_table_segment_sum_plain(x2, es2.win_src, es2.win_local, es2.win_tile_map, es2.num_windows),
        lambda: torch.sparse.mm(csr2, x2),
        (es2.win_src, es2.win_local, es2.win_tile_map),
    )

    et3 = pick(("span",))
    es3 = graph.edges[et3]
    x3 = torch.randn(es3.num_src, d, generator=gen).to(dev)
    csr3 = _csr(es3.row_ptr, es3.src, es3.num_dst, es3.num_src, dev)
    span_args = (es3.span_src, es3.span_local, es3.span_tile_map, es3.span_base, es3.num_windows, es3.span_rows)
    check(
        "span_segment_sum", et3, x3,
        lambda: sk.span_segment_sum(x3, *span_args),
        lambda: sk.span_segment_sum_plain(x3, *span_args),
        lambda: torch.sparse.mm(csr3, x3),
        span_args[:4],
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
    del x3_nan
    _phase("kernels", t0, "K1, K2f, K3 match their plain versions")

    # 5. slice -------------------------------------------------------------
    t0 = time.perf_counter()
    model = build_model(config, graph_cpu, device="cpu", generator=torch.Generator().manual_seed(0))
    model_cpu = copy.deepcopy(model)
    model.to(dev)
    reset_counts()
    t_state = time.perf_counter()
    state = compute_node_state(model, graph)
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t_state
    after_state = dict(sk.launch_counts)
    if not all(after_state[k] for k in ("segment_sum_windowed", "fused_table_segment_sum", "span_segment_sum")):
        raise AssertionError(f"a kernel of the serving path did not launch: {after_state}")
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
    serving_launches = {k: sk.launch_counts[k] for k in after_state}  # the serving path ends here
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
    del model, model_cpu, state, state_plain, fn, fn_plain

    # 7. train-kernels -----------------------------------------------------
    t0 = time.perf_counter()
    masker = masker_from_config(config, graph_cpu)
    batch_cpu = masker.get_split("train")
    plan = batch_cpu.patient_plan
    if not (plan.identity and plan.lab_span_mode and plan.lab_block_rows == 256):
        raise AssertionError("the scale_100k train batch is not slot-major with span@256 lab tiles")
    batch = batch_cpu.to(dev)
    plan = batch.patient_plan
    num_tiles = plan.win_local.shape[0] // TILE_E
    low = (graph.patient_lab_degree[batch.patient_idx.long()] < config.model.degree_threshold).reshape(
        -1, TILE_E
    )
    masks = {"gnn": (~low).any(dim=1).to(torch.int32), "tab": low.any(dim=1).to(torch.int32)}
    real = plan.win_local < WINDOW
    active = {
        k: int((real.reshape(-1, TILE_E) & (m[:, None] != 0)).sum()) for k, m in masks.items()
    }
    bases = plan.lab_block_map
    print(
        f"    train batch: rows {batch.num_valid}  slots {plan.win_local.shape[0]} "
        f"({plan.win_local.shape[0] / batch.num_valid:.3f}x)  tiles {num_tiles}  "
        f"windows {plan.num_windows}  lab span bases {int(bases.min())}..{int(bases.max())}  "
        f"tiles run: GNN head {float(masks['gnn'].float().mean()):.4f}, "
        f"tabular head {float(masks['tab'].float().mean()):.4f}"
    )
    # The JAX package's table path (graph/build.py) numbers patients by
    # ascending lab degree and labs by descending frequency
    # (graph.cluster_patients_by_degree and cluster_labs_by_frequency); the
    # port keeps the generator's order.  The same train rows, numbered so:
    p_tr, l_tr, v_tr = masker.split_arrays("train")
    deg = graph_cpu.patient_lab_degree.numpy()
    es_pl = graph_cpu.edges[PATIENT_LAB]
    freq = np.bincount(es_pl.dst.numpy()[es_pl.mask.numpy() > 0], minlength=num_l)
    p_new, l_new = np.empty(num_p, np.int64), np.empty(num_l, np.int64)
    p_new[np.argsort(deg, kind="stable")] = np.arange(num_p)
    l_new[np.argsort(-freq, kind="stable")] = np.arange(num_l)
    relabelled, _ = _pad_batch(
        p_new[p_tr], l_new[l_tr], v_tr, masker.pad_multiple, num_p, num_l, slot_major=True,
        lab_block_rows=plan.lab_block_rows,
    )
    low_r = (np.sort(deg)[relabelled.patient_idx.numpy()] < config.model.degree_threshold).reshape(-1, TILE_E)
    print(
        f"    the same rows with the JAX package's degree / frequency numbering: slots "
        f"{relabelled.patient_idx.shape[0]}  tiles {low_r.shape[0]}  tiles run: GNN head "
        f"{float((~low_r).any(axis=1).mean()):.4f}, tabular head {float(low_r.any(axis=1).mean()):.4f}"
    )
    del relabelled, low_r

    # K2b on the three fused-table relations; the largest one is timed
    for et in sorted((et for et, t in tiers.items() if t == "fused_table"),
                     key=lambda et: -graph.edges[et].num_valid):
        es = graph.edges[et]
        g = torch.randn(es.num_dst, d, generator=gen).to(dev)
        args = (es.win_src, es.win_local, es.win_tile_map, es.num_src)
        src_count = torch.bincount(es.win_src[es.win_local < WINDOW].long(), minlength=es.num_src)
        per_src = src_count.clamp_min(1).double()[:, None]
        got, want = sk.fused_table_segment_sum_bwd(g, *args), sk.fused_table_segment_sum_bwd_plain(g, *args)
        torch.cuda.synchronize()
        max_abs, _ = _compare(
            f"fused_table_segment_sum_bwd on {'/'.join(et)} (per-source means)",
            got / per_src, want / per_src, KERNEL_ATOL, KERNEL_RTOL,
        )
        if "fused_table_segment_sum_bwd" not in results:
            mirror = graph.edges[mirror_edge_type(et)]
            csr_t = _csr(mirror.row_ptr, mirror.src, mirror.num_dst, mirror.num_src, dev)
            timed(
                "fused_table_segment_sum_bwd",
                lambda g=g, args=args: sk.fused_table_segment_sum_bwd(g, *args),
                lambda g=g, args=args: sk.fused_table_segment_sum_bwd_plain(g, *args),
                lambda g=g, csr_t=csr_t: torch.sparse.mm(csr_t, g),
                _nbytes(g, *args[:3]) + es.num_src * d * 4, es.num_valid * d, max_abs,
            )

    # K1 as the span tier's backward: the mirror plan over the lab gradient
    rev3 = graph.edges[mirror_edge_type(et3)]
    g3 = torch.randn(es3.num_dst, d, generator=gen).to(dev)
    k1b = (rev3.win_src, rev3.win_local, rev3.win_tile_map, rev3.num_windows)
    max_abs, _ = _compare(
        f"segment_sum_windowed as the backward of {'/'.join(et3)}",
        mean_of(sk.segment_sum_windowed(g3, *k1b), rev3), mean_of(sk.segment_sum_windowed_plain(g3, *k1b), rev3),
        KERNEL_ATOL, KERNEL_RTOL,
    )
    csr_rev3 = _csr(rev3.row_ptr, rev3.src, rev3.num_dst, rev3.num_src, dev)
    saved = results.pop("segment_sum_windowed")
    timed(
        "segment_sum_windowed", lambda: sk.segment_sum_windowed(g3, *k1b),
        lambda: sk.segment_sum_windowed_plain(g3, *k1b), lambda: torch.sparse.mm(csr_rev3, g3),
        _nbytes(g3, *k1b[:3]) + rev3.num_windows * WINDOW * d * 4, rev3.num_valid * d, max_abs,
    )
    k1_backward = results.pop("segment_sum_windowed")
    results["segment_sum_windowed"] = saved

    # K4f / K4b at the batch's shapes, random head weights
    hg = torch.Generator().manual_seed(1)
    head = [
        torch.randn(num_p, 64, generator=hg), torch.randn(num_l, 64, generator=hg),
        torch.randn(64, 32, generator=hg) * 0.1, torch.randn(32, generator=hg) * 0.1,
        torch.randn(32, generator=hg) * 0.1, torch.tensor([0.3]),
    ]
    head = [h.to(dev) for h in head]
    g_out = (torch.randn(plan.win_local.shape[0], generator=hg).to(dev) * real).contiguous()
    seed = (2024, 7)

    def head_call(fn, rate, mask, *extra):
        return fn(
            *head, batch.lab_idx, plan.win_local, plan.win_tile_map, seed, mask, plan.lab_block_map,
            rate, plan.lab_block_rows, *extra,
        )

    names = ("proj_p", "proj_l", "w1", "b1", "w2", "b2")
    for rate in (0.0, 0.2):
        for mname, mask in masks.items():
            tag = f"rate {rate}, {mname} head tiles"
            fwd_err, _ = _compare(
                f"pair_head_fwd ({tag})", head_call(pk.pair_head_fwd, rate, mask),
                head_call(pk.pair_head_fwd_plain, rate, mask), HEAD_ATOL, HEAD_RTOL,
            )
            margin = pk.relu_margin_plain(
                *head[:4], batch.lab_idx, plan.win_local, plan.win_tile_map, seed, mask,
                plan.lab_block_map, rate, plan.lab_block_rows,
            )
            g_safe = torch.where(margin > KINK_MARGIN, g_out, torch.zeros_like(g_out))
            on = (real.reshape(-1, TILE_E) & (mask[:, None] != 0)).reshape(-1)
            print(f"    {int((on & (margin <= KINK_MARGIN)).sum())} of {int(on.sum())} active slots "
                  f"lie within {KINK_MARGIN:g} of a ReLU kink: kept out of the backward check")
            got = head_call(pk.pair_head_bwd, rate, mask, plan.num_windows, g_safe)
            want = head_call(pk.pair_head_bwd_plain, rate, mask, g_safe)
            bwd_err = max(
                _compare_scaled(f"pair_head_bwd d{n} ({tag})", a, b, GRAD_REL)
                for n, a, b in zip(names, got, want)
            )
            del got, want
            if rate > 0 and mname == "gnn":
                head_bytes = _nbytes(*head, batch.lab_idx, plan.win_local, plan.win_tile_map, mask,
                                     plan.lab_block_map)
                timed(
                    "pair_head_fwd", lambda m=mask: head_call(pk.pair_head_fwd, 0.2, m),
                    lambda m=mask: head_call(pk.pair_head_fwd_plain, 0.2, m), None,
                    head_bytes + plan.win_local.shape[0] * 4, active[mname] * HEAD_FWD_FLOPS, fwd_err,
                )
                timed(
                    "pair_head_bwd",
                    lambda m=mask: head_call(pk.pair_head_bwd, 0.2, m, plan.num_windows, g_out),
                    lambda m=mask: head_call(pk.pair_head_bwd_plain, 0.2, m, g_out), None,
                    head_bytes + _nbytes(g_out) + _nbytes(*head), active[mname] * HEAD_BWD_FLOPS,
                    bwd_err,
                )
            elif rate > 0:
                print(
                    f"    pair head, tabular head tiles: kernel fwd "
                    f"{_median_ms(lambda m=mask: head_call(pk.pair_head_fwd, 0.2, m)):.4f} ms  bwd "
                    f"{_median_ms(lambda m=mask: head_call(pk.pair_head_bwd, 0.2, m, plan.num_windows, g_out)):.4f} ms"
                )
    _phase("train-kernels", t0, "K2b, K1 as a backward, K4f and K4b match their plain versions")

    # 8. train-step --------------------------------------------------------
    t0 = time.perf_counter()
    cfg0 = dataclasses.replace(config, model=dataclasses.replace(config.model, dropout=0.0))
    model_gpu = build_model(cfg0, graph_cpu, generator=torch.Generator().manual_seed(0))
    model_ref = build_model(cfg0, graph_cpu, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model_gpu, graph, masker, cfg0)
    trainer_ref = Trainer(model_ref, graph_cpu, masker, cfg0, device="cpu")
    sup = masker.supervision_mask(0, batch_cpu)
    b_gpu, b_ref = trainer.get_batch("train"), trainer_ref.get_batch("train")
    reset_counts()
    with torch.no_grad():
        model_gpu.predict_lab_values(
            graph, b_gpu.patient_idx, b_gpu.lab_idx, train=False, patient_plan=b_gpu.patient_plan,
            lab_plan=b_gpu.lab_plan, degrees=b_gpu.degrees,
        )
    torch.cuda.synchronize()
    forward_launches = read_counts()
    reset_counts()
    t_step = time.perf_counter()
    loss = trainer.train_step(b_gpu, sup.to(dev), 0)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t_step
    step_launches = read_counts()
    if not all(step_launches.values()):
        raise AssertionError(f"a kernel of the training path did not launch: {step_launches}")
    t_ref = time.perf_counter()
    loss_ref = trainer_ref.train_step(b_ref, sup, 0)
    ref_s = time.perf_counter() - t_ref
    _compare("train step loss", torch.tensor(loss), torch.tensor(loss_ref), 0.0, STEP_LOSS_RTOL)
    params = dict(model_gpu.named_parameters())
    # every gradient is printed; a failure raises after the train phase
    floor = STEP_GRAD_ZERO_FLOOR * max(float(p.grad.norm()) for p in model_ref.parameters())
    failed_grads = [
        name for name, p_ref in model_ref.named_parameters()
        if not _compare_norm(f"grad {name}", params[name].grad, p_ref.grad, STEP_GRAD_NORM_REL, floor)
    ]
    for name, p_ref in model_ref.named_parameters():
        diff = (params[name].detach().cpu() - p_ref.detach()).abs()
        if float(diff.max()) > STEP_PARAM_ATOL:
            raise AssertionError(f"param {name}: max |d| {float(diff.max()):.3e} > {STEP_PARAM_ATOL}")
    moved = sum(
        int(((params[n].detach().cpu() - p.detach()).abs() > 1e-5).sum())
        for n, p in model_ref.named_parameters()
    )
    print(
        f"    params after Adam: max |d| <= {STEP_PARAM_ATOL:g} ok; "
        f"{moved} of {sum(p.numel() for p in model_ref.parameters())} elements differ by > 1e-5"
    )
    buffers = dict(model_gpu.named_buffers())
    for name, b in model_ref.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _compare(f"bn {name}", buffers[name], b, STEP_BN_ATOL, STEP_BN_RTOL)
    k1_fwd = forward_launches["segment_sum_windowed"]
    print(
        f"    launches in one step {step_launches}; of them in the forward {forward_launches} "
        f"(K1 as a backward: {step_launches['segment_sum_windowed'] - k1_fwd})"
    )
    _phase(
        "train-step", t0,
        f"loss {loss:.6f} (CPU plain {loss_ref:.6f})  first step on the card {step_s * 1e3:.1f} ms, "
        f"CPU plain step {ref_s:.1f} s",
    )
    del model_gpu, model_ref, trainer, trainer_ref

    # 9. train -------------------------------------------------------------
    t0 = time.perf_counter()
    model = build_model(config, graph_cpu, generator=torch.Generator().manual_seed(1))
    trainer = Trainer(model, graph, masker, config)
    trainer.train_epoch()  # warm-up: first launches, allocator
    trainer.epoch += 1
    torch.cuda.synchronize()
    reset_counts()
    epoch_ms, losses = [], []
    for _ in range(TRAIN_EPOCHS):
        t_ep = time.perf_counter()
        losses.append(trainer.train_epoch())
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t_ep) * 1e3)
        trainer.epoch += 1
    train_launches = read_counts()  # the training path ends here
    if not all(train_launches.values()):
        raise AssertionError(f"a kernel of the training path did not launch: {train_launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    val_loss = trainer.validate("val")
    if not np.isfinite(val_loss):
        raise AssertionError(f"non-finite validation loss {val_loss}")
    n_train = masker.split_sizes()["train"]
    edges_per_s = n_train * TRAIN_EPOCHS / (sum(epoch_ms) / 1e3)
    print(f"    losses {['%.6f' % x for x in losses]}  val loss {val_loss:.6f}")
    print(f"    epoch ms {['%.2f' % x for x in epoch_ms]}  launches in {TRAIN_EPOCHS} epochs {train_launches}")

    wall_ms, busy_ms, top = _device_profile(trainer.train_epoch)
    print(
        f"    profiled epoch: wall {wall_ms:.2f} ms  device busy {busy_ms:.2f} ms  "
        f"idle share {max(0.0, 1 - busy_ms / wall_ms):.4f}"
    )
    for name, ms in top[:12]:
        print(f"      {ms:9.3f} ms  {100 * ms / max(busy_ms, 1e-9):5.1f} %  {name[:130]}")
    _phase(
        "train", t0,
        f"{TRAIN_EPOCHS} epochs, dropout {config.model.dropout}: median epoch "
        f"{statistics.median(epoch_ms):.2f} ms  train_patient_lab_edges_per_sec {edges_per_s:.1f} "
        f"({n_train} train rows)",
    )

    if failed_grads:
        raise AssertionError(f"train-step gradients outside tolerance: {failed_grads}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches[name], **results[name],
        }
        if name in serving_launches:
            entry["launches_serving"] = serving_launches[name]
        if name == "segment_sum_windowed":
            entry["as_span_backward"] = k1_backward
        kernels.append(entry)
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
