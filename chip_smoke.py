#!/usr/bin/env python3
"""Smoke run of the PyTorch port's RGCN and HGT serving and training paths,
the RGCN's dual-head training path, the gather probe, the bench, the
trainer's lifecycle (checkpoints, resume, evaluation) and the pipeline
command line on the flagship config on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device        the card's name and power limit (nvidia-smi); TF32 off
  2. build         compile csrc/*.cu for sm_90a, one nvcc per source; the
                   -Xptxas -v lines of every kernel, and by name those of
                   K2b and K3 (the two instances of incidence_kernel), K2f
                   and K1 (gather_runs_kernel, gather_tile_kernel's two
                   instances), K6 and its merge, K7, K8's two routes, K4f,
                   K4b, K5f and K5b
  3. graph         the scale_100k synthetic graph (seed 0, 100k patients, ~5M
                   patient-lab edges, numbered as the JAX package numbers
                   nodes), dense budget 0, span rows 256; per relation its
                   aggregation tier, edges, windows and tiles
  4. kernels       K1, K2f, K3 against their plain PyTorch versions at the
                   graph's relation shapes: errors, tolerance, median times;
                   K1 on every relation it aggregates; K2f on the three
                   fused-table relations, also with NaN rows past the table,
                   timed in turns with torch.sparse.mm (library, kernel,
                   kernel, library); the launch shapes and dynamic shared
                   memory of K2f and K3 (K2b's in 7)
  5. slice         the RGCN at full width (hidden 128, 2 layers, heads (64,
                   32), float32, seeded weights): compute_node_state with the
                   kernels on the GPU against the plain versions on the CPU
  6. requests      build_serving_fn, three 500-lab patient requests and
                   batches of 256 and 4096 pairs, held against the plain
                   state's answers
  7. train-kernels the slot-major span@256 train batch (split seed 42); K2b on
                   the three fused-table relations (each timed), K1 as the
                   span tier's backward, K4f and K4b (dropout 0 and 0.2, both
                   heads' tile masks; each head timed and bounded, each
                   forward beside the time of its dropout hashes and of its
                   gathered rows) against their plain versions at these
                   shapes; K4f also without a tile mask and with NaN rows
                   past proj_l and past the window-padded proj_p; K4f's and
                   K4b's launch shapes; K4f and K4b at 720 and 2048 labs (the
                   batch's patients, labs from a seed) with lab_tile_rows 256
                   and 0
  8. train-step    one Adam step with dropout 0 on the card against the same
                   step with the plain versions on the CPU: loss, every
                   gradient, the parameters and the BatchNorm statistics;
                   every kernel of the path launched; K1 at each of the
                   step's call sites (by plan and role, recorded in the
                   step) against its plain version, NaN rows past the table
                   too, timed in turns with torch.sparse.mm with its bound,
                   and the step's sum
  9. train         5 epochs with dropout 0.2 on the card (the training path's
                   launch counts), the median epoch time, the bench's
                   train_patient_lab_edges_per_sec, a validation loss, and
                   one torch.profiler epoch: top device kernels, idle share
 10. hgt-graph     the HGT attention plans of the same graph: per destination
                   group its edges, windows, resident or span layouts, tiles
 11. hgt-kernels   K6, K7, K8 against their plain versions on every group's
                   plans (both layouts), also with NaN rows past every table;
                   each kernel's launch (K8's route, column slices) per
                   group; the library yardstick, one
                   scaled_dot_product_attention over the group's dense
                   additive mask (log edge count, -inf), its backend, its
                   out against K6's plain version on rows with edges; every
                   group's K6 timed in turns with SDPA's forward and K7, K8
                   with its backward (library, kernel, kernel, library),
                   plain times and bounds
 12. hgt-slice     the HGT at full width (hidden 128, 2 layers, 4 heads, head
                   (64, 32), seeded weights): compute_node_state on the flash
                   tier against the same weights on the segment tier (plain
                   PyTorch) on the card, and three 500-lab patient requests
 13. hgt-train-step one Adam step with dropout 0, flash tier against segment
                   tier: loss, every gradient, the parameters, peak memory;
                   K6, K7 and K8 launched
 14. hgt-train     5 HGT epochs with dropout 0.2: median epoch time,
                   train_patient_lab_edges_per_sec, a validation loss, launch
                   counts, one profiled epoch
 15. dual-kernels  the train batch with lab_tile_rows 0 (the full lab table;
                   slots, tiles, each head's share of tiles); K5f and K5b
                   against their plain versions at dropout 0 and 0.2, with
                   both heads' tile masks and without, and with NaN rows past
                   proj_l and past the window-padded proj_p; K5f with the
                   tabular head masked on every tile; K5f and K5b at 720 and
                   2048 labs; K5f's and K5b's launch shapes; K5f / K5b timed
                   against K4f / K4b of both heads on the same batch, K5f
                   beside the time of its dropout hashes and gathered rows
 16. dual-train-step one Adam step with dropout 0, dual_head_fusion on
                   against off, both on the card from the same weights and
                   masks: loss, every gradient, the parameters; K5 launched
                   and K4 not on one side, the other way round on the other
 17. dual-train    5 epochs with dropout 0.2 each of dual_head_fusion on and
                   off (lab_tile_rows 0) and the default span@256, in turns
                   (one epoch of each a round, the order reversed every other
                   round): median epochs, on's train_patient_lab_edges_per_sec,
                   a validation loss, an eval step over the train batch (K5f),
                   one profiled epoch of on
 18. gather-probe  P1: python -m multi_modal_gnn_tpu_torch.tools.bench_gather
                   at the script's defaults (3840 tiles, 512 rows, H 64),
                   then A / B / C against their plain versions at H 64 and
                   128: errors, median times, bounds, library times
 19. bench         python -m multi_modal_gnn_tpu_torch.tools.bench --scale
                   --no-dense --quick through run_bench: its JSON line, a
                   finite positive value, the card named in its device, and
                   K1-K4 launched in its timed chunks
 20. lifecycle     on phase 3's graph at full width (dropout 0.2):
                   train_pipeline for 4 epochs (checkpoints every 2) twice,
                   whose relative drift over the losses of epochs 3-4 sets
                   the tolerance (twice it); a fresh trainer's
                   fit(resume_from="auto") from the first run's
                   checkpoint_epoch_2.ckpt to epoch 4, held to that run
                   within it; load_best_model, evaluate_model (baselines
                   global_mean, per_lab_mean; conformal alpha 0.1) and its
                   artifacts; predict_pairs on 4096 test pairs against
                   predict("test") within 1e-5
Then a JSON line of per-kernel results, the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the last line; without a CUDA device it fails in phase 1.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

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
# lab counts beside scale_100k's 500 at which K4f, K4b, K5f and K5b are checked:
# mimic_scale's 720 and the fused-table tier's largest table
LAB_COUNTS = (720, 2048)
TRAIN_EPOCHS = 5
# phase 20: train_pipeline's epochs and the test pairs predict_pairs answers.
# Two runs from scratch differ most through their first Adam steps, where a
# near-zero gradient whose sign the reordered sums flip moves a parameter by
# up to 2 * lr: 1.0e-6 to 8.7e-6 (relative, losses of epochs 3-4) between
# pairs of runs, while runs resumed from one epoch-2 checkpoint stayed within
# 7.5e-8 of the run that wrote it, and agreed with it to the bit in most runs
# (NVIDIA H100 80GB HBM3, 700.00 W).  A resume that drops the Adam state must
# fall outside the tolerance, or the phase fails.
LIFECYCLE_EPOCHS = 4
PAIRS_CHECKED = 4096
# phase 21: conf/eicu_real.yaml (data seed 0) at these train seeds, held to
# the band of the JAX package's guarded (±3σ-winsorized) test metrics at
# the same seeds, widened by the margins: the port's init, dropout and
# supervision draws come from other generators, so it is held to the band,
# not to bits.  The JAX values are `python scripts/flagship_band_jax.py`
# (run_pipeline.py on the CPU), seeds 42, 43, 44 in order
FLAGSHIP_SEEDS = (42, 43, 44)
JAX_CPU_BAND = {
    "r2": (0.2762996202366431, 0.2935480948964422, 0.28611317018904725),
    "mae": (0.5670451351436947, 0.5818913650723917, 0.5776210355387869),
}
FLAGSHIP_R2_MARGIN, FLAGSHIP_MAE_MARGIN = 0.02, 0.015
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores; TF32 is off
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Printed beside a pair-head forward's bound (which stays bytes or f32
# FLOPs, comparable across PRs): its dropout hashes, 96 an active slot (64
# on layer 0, 32 on layer 1), each 10 int32 operations (murmur3's finalizer:
# 2 multiplies, 3 shifts, 3 xors; the counter's xor; the compare), at the
# int32 rate of 64 lanes an SM, a quarter of FP32_FLOPS (128 f32 lanes an
# SM, an FMA counting 2); and its gathered Pp / Pl rows, 2 x 256 B an active
# slot, at the HBM rate (an upper bound: most come from L2 or L1)
HEAD_HASHES, HASH_INT_OPS = 96, 10
INT32_OPS = FP32_FLOPS / 4

SEGMENT_SOURCE = "multi_modal_gnn_tpu_torch/csrc/segment.cu"
# the -Xptxas -v lines printed by name: K2b and K3 (the two instances of one
# kernel template in SEGMENT_SOURCE), K2f and K1 (K2f's kernel and the two
# instances of gather_tile_kernel), K8's two routes, K4f, K4b, K5f and K5b
NAMED_KERNELS = (
    ("K2b incidence_kernel<false>", "incidence_kernelILb0E"),
    ("K3 incidence_kernel<true>", "incidence_kernelILb1E"),
    ("K2f and K1 on a small table gather_runs_kernel", "18gather_runs_kernel"),
    ("K1 on a large table gather_tile_kernel<false>", "gather_tile_kernelILb0E"),
    ("K1 on pre-gathered rows gather_tile_kernel<true>", "gather_tile_kernelILb1E"),
    ("K6 flash_rows_kernel<FWD>", "17flash_rows_kernelILi0E"),
    ("K6 merge flash_fwd_merge_kernel", "22flash_fwd_merge_kernel"),
    ("K7 flash_rows_kernel<DQ>", "17flash_rows_kernelILi1E"),
    ("K8 sort route flash_dkv_kernel", "16flash_dkv_kernel"),
    ("K8 table route flash_dkv_table_kernel", "22flash_dkv_table_kernel"),
    ("K4f pair_head_fwd_kernel", "20pair_head_fwd_kernel"),
    ("K4b pair_head_bwd_kernel", "20pair_head_bwd_kernel"),
    ("K5f pair_head_dual_fwd_kernel", "25pair_head_dual_fwd_kernel"),
    ("K5b pair_head_dual_bwd_kernel", "25pair_head_dual_bwd_kernel"),
)
PAIRHEAD_SOURCE = "multi_modal_gnn_tpu_torch/csrc/pairhead.cu"
ATTENTION_SOURCE = "multi_modal_gnn_tpu_torch/csrc/attention.cu"
PROBE_SOURCE = "multi_modal_gnn_tpu_torch/csrc/gather_probe.cu"
KERNELS = {  # wrapper: (source, the TPU kernel it replaces)
    "segment_sum_windowed": (SEGMENT_SOURCE, "multi_modal_gnn_tpu/ops/pallas_segment.py:117"),
    "fused_table_segment_sum": (SEGMENT_SOURCE, "multi_modal_gnn_tpu/ops/pallas_segment.py:279"),
    "fused_table_segment_sum_bwd": (SEGMENT_SOURCE, "multi_modal_gnn_tpu/ops/pallas_segment.py:357"),
    "span_segment_sum": (SEGMENT_SOURCE, "multi_modal_gnn_tpu/ops/pallas_segment.py:529"),
    "pair_head_fwd": (PAIRHEAD_SOURCE, "multi_modal_gnn_tpu/ops/pallas_pairhead.py:296"),
    "pair_head_bwd": (PAIRHEAD_SOURCE, "multi_modal_gnn_tpu/ops/pallas_pairhead.py:362"),
    "flash_attention_fwd": (ATTENTION_SOURCE, "multi_modal_gnn_tpu/ops/pallas_attention.py:216"),
    "flash_attention_dq": (ATTENTION_SOURCE, "multi_modal_gnn_tpu/ops/pallas_attention.py:363"),
    "flash_attention_dkv": (ATTENTION_SOURCE, "multi_modal_gnn_tpu/ops/pallas_attention.py:508"),
    "pair_head_dual_fwd": (PAIRHEAD_SOURCE, "multi_modal_gnn_tpu/ops/pallas_pairhead.py:692"),
    "pair_head_dual_bwd": (PAIRHEAD_SOURCE, "multi_modal_gnn_tpu/ops/pallas_pairhead.py:742"),
    "gather_probe_indicator": (PROBE_SOURCE, "scripts/bench_gather_impl.py:47"),
    "gather_probe_padded": (PROBE_SOURCE, "scripts/bench_gather_impl.py:47"),
    "gather_probe_direct": (PROBE_SOURCE, "scripts/bench_gather_impl.py:47"),
}
# the RGCN training path's kernels with single heads (phases 8, 9) and with
# the dual heads (phases 16, 17)
SEGMENT_KERNELS = (
    "segment_sum_windowed", "fused_table_segment_sum", "fused_table_segment_sum_bwd", "span_segment_sum",
)
RGCN_KERNELS = (*SEGMENT_KERNELS, "pair_head_fwd", "pair_head_bwd")
DUAL_KERNELS = (*SEGMENT_KERNELS, "pair_head_dual_fwd", "pair_head_dual_bwd")
HEAD_PATH_KERNELS = (*RGCN_KERNELS, "pair_head_dual_fwd", "pair_head_dual_bwd")
# FLOPs per active slot: pre0 adds (64), h0 @ W1 (2 * 64 * 32), b1 (32),
# h1 . w2 (2 * 32); the backward adds dw2 (64), dpre1 @ W1^T and the dW1
# outer products (2 * 2 * 64 * 32) and the dPp / dPl scatters (2 * 64)
HEAD_FWD_FLOPS = 64 + 2 * 64 * 32 + 32 + 2 * 32
HEAD_BWD_FLOPS = HEAD_FWD_FLOPS + 64 + 2 * 2 * 64 * 32 + 2 * 64
# HGT: 4 heads of 32 columns.  FLOPs per edge and column: K6 takes q . k and
# p * v (2 + 2); K7 and K8 about twice that (q . k, dO . v and one or two
# weighted sums)
HGT_HEADS = 4
HGT_FWD_FLOPS_PER_COL = 4
HGT_BWD_FLOPS_PER_COL = 8
HGT_PLAIN_REPS = 5  # the plain versions gather [E, 128] tensors: fewer repetitions
# A whole HGT step, flash tier against the segment tier, both on the card,
# per gradient tensor in the 2-norm (plus STEP_GRAD_ZERO_FLOOR).  The two
# tiers sum every softmax and its backward in another order, so the head's
# inputs differ in the last bits; a head unit within that rounding of its
# ReLU's kink, or a prediction within it of its target under the MAE, takes
# the other branch and moves its rows' gradients by a whole term.  The
# embedding tables, which collect those rows, drift most: embed_patient
# 3.4e-3 to 3.5e-3, embed_lab 1.8e-3 to 1.9e-3 in three runs, every other
# tensor below 1e-3 of its norm or under the floor (NVIDIA H100 80GB HBM3,
# 700.00 W).  Held to three times the largest drift; a fault of the path (a
# group's gradient dropped, misscaled or sent through the wrong plan) moves
# whole terms of a tensor
HGT_STEP_GRAD_NORM_REL = 1e-2


def _ptxas_report(log: str, entry: str) -> list:
    """The ``-Xptxas -v`` lines (registers, shared memory, stack, spills) of
    the kernel whose mangled name contains ``entry``."""
    lines, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = entry in ln
        elif inside and any(w in ln for w in ("registers", "spill", "stack")):
            lines.append(ln.replace("ptxas info    :", "").strip())
    return lines


def _tree_state(path: Path) -> list:
    """Every file under ``path`` with its size and modification time."""
    if not path.exists():
        return []
    return sorted((str(p), p.stat().st_size, p.stat().st_mtime_ns) for p in path.rglob("*") if p.is_file())


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


def _head_fwd_floors(active: int) -> dict:
    """The times printed beside a pair-head forward's bound (dropout on):
    its dropout hashes at the int32 rate and its gathered rows at the HBM
    rate.  Derived, not measured: printed only, never in the kernels line."""
    return {"hash_ms": active * HEAD_HASHES * HASH_INT_OPS / INT32_OPS * 1e3,
            "gather_ms": active * 2 * 64 * 4 / HBM_BYTES_PER_S * 1e3}


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


def _sdpa_yardstick(q, k, v, dout, src, local, tile_map, num_windows, num_heads, n, ns) -> dict:
    """One ``scaled_dot_product_attention`` call computing K6's function on
    the group (and, by its backward, K7's and K8's): q ``[1, nh, n, dh]``,
    k and v ``[1, nh, ns, dh]``, the dense additive mask ``[n, ns]`` from
    the plan's forward arrays (log of each pair's edge count, -inf without
    an edge), scale 1 (q arrives scaled).  The memory-efficient backend
    where it takes f32 and this mask, else the math backend.  Returns the
    backend's name, ``out`` ``[n, h]`` and the timed calls; the port never
    calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from multi_modal_gnn_tpu_torch.ops import attention_kernels as ak

    row, s = ak._slots(src, local, tile_map)
    bias = torch.zeros(n, ns, dtype=torch.float32, device=q.device)
    bias.index_put_((row, s), torch.ones_like(row, dtype=torch.float32), accumulate=True)
    bias.log_()  # log(count); log(0) = -inf
    heads = lambda x: x.reshape(x.shape[0], num_heads, -1).transpose(0, 1).unsqueeze(0).contiguous()  # noqa: E731
    qh, kh, vh = (heads(x).requires_grad_() for x in (q, k, v))
    gh = heads(dout)
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=1.0)
                torch.cuda.synchronize()
            break
        except RuntimeError as exc:
            print(f"    SDPA {backend.name} refused ({type(exc).__name__}: {str(exc)[:160]}); trying the next")
    else:
        raise AssertionError("no SDPA backend takes the f32 inputs and the mask")

    def fwd():
        with torch.no_grad(), sdpa_kernel(backend):
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=1.0)

    def bwd():
        return torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True)

    return {
        "backend": backend.name, "fwd": fwd, "bwd": bwd,
        "out": out.detach()[0].transpose(0, 1).reshape(n, -1),
    }


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


def _trained_head_check(trainer, dropout_seed: int = 0) -> dict:
    """K4f and K4b against their plain versions on what a trained model's
    factored heads get from its own train batch: one train-mode forward
    captures each head's node states, batch plan, tile mask and dropout
    seed, and each head's trained projections and MLP weights go through
    the kernels and the plain versions, the backward with a seeded upstream
    gradient, held to phase 7's tolerances.  {head: (fwd err, bwd err)}."""
    import inspect

    import torch

    from multi_modal_gnn_tpu_torch.graph.hetero import WINDOW
    from multi_modal_gnn_tpu_torch.models.layers import FactoredEdgeHead
    from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk

    batch = trainer.get_batch("train")
    plan = batch.patient_plan
    if not plan.identity:
        raise AssertionError("the trained model's train batch is not slot-major")
    calls = []

    def capture(module, args, kwargs, name):
        bound = inspect.signature(module.forward).bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append((name, module, dict(bound.arguments)))

    heads = [(n, m) for n, m in trainer.model.named_modules() if isinstance(m, FactoredEdgeHead)]
    hooks = [
        m.register_forward_pre_hook(lambda mod, a, kw, n=n: capture(mod, a, kw, n), with_kwargs=True)
        for n, m in heads
    ]
    try:
        with torch.no_grad():
            trainer.model.train()
            trainer.model.predict_lab_values(
                trainer.graph, batch.patient_idx, batch.lab_idx, train=True, patient_plan=plan,
                lab_plan=batch.lab_plan, degrees=batch.degrees, dropout_seed=dropout_seed,
            )
    finally:
        for hook in hooks:
            hook.remove()
        trainer.model.eval()
    if not calls or not all(module.fused_widths() for _, module, _ in calls):
        raise AssertionError(f"the trained model has no fused factored head: {[n for n, _, _ in calls]}")
    names = ("proj_p", "proj_l", "w1", "b1", "w2", "b2")
    gen = torch.Generator().manual_seed(dropout_seed + 1)
    errs = {}
    for name, mod, a in calls:
        with torch.no_grad():
            head = [
                mod.proj_patient(a["x_p_nodes"]), mod.proj_lab(a["x_l_nodes"]), mod.dense_1.weight.t(),
                mod.dense_1.bias, mod.dense_out.weight[0], mod.dense_out.bias,
            ]
        head = [t.detach().float().contiguous() for t in head]
        rate = mod.dropout if a["train"] else 0.0
        args = (
            a["l_idx"], plan.win_local, plan.win_tile_map, tuple(int(s) for s in a["seed"]), a["tile_mask"],
            plan.lab_block_map, rate, plan.lab_block_rows,
        )
        tag = (f"{name}, trained, {head[0].shape[0]} patients x {head[1].shape[0]} labs, "
               f"{plan.win_local.shape[0]} slots, rate {rate}")
        fwd_err, _ = _compare(f"pair_head_fwd ({tag})", pk.pair_head_fwd(*head, *args),
                              pk.pair_head_fwd_plain(*head, *args), HEAD_ATOL, HEAD_RTOL)
        real = plan.win_local < WINDOW
        g_out = (torch.randn(plan.win_local.shape[0], generator=gen).to(real.device) * real).contiguous()
        margin = pk.relu_margin_plain(*head[:4], *args)
        g_safe = torch.where(margin > KINK_MARGIN, g_out, torch.zeros_like(g_out))
        got = pk.pair_head_bwd(*head, *args, plan.num_windows, g_safe)
        want = pk.pair_head_bwd_plain(*head, *args, g_safe)
        bwd_err = max(
            _compare_scaled(f"pair_head_bwd d{n} ({tag})", x, y, GRAD_REL) for n, x, y in zip(names, got, want)
        )
        errs[name] = (fwd_err, bwd_err)
    return errs


def main() -> int:
    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
    from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
    from multi_modal_gnn_tpu_torch.graph.hetero import SPAN_MIN_SRC, TILE_E, WINDOW
    from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, mirror_edge_type
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.ops import _build, aggregation_tier
    from multi_modal_gnn_tpu_torch.ops import segment as seg_ops
    from multi_modal_gnn_tpu_torch.ops import attention_kernels as ak
    from multi_modal_gnn_tpu_torch.ops import gather_probe as gp
    from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
    from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
    from multi_modal_gnn_tpu_torch.serving import (
        build_serving_fn,
        compute_node_state,
        predict_patient,
    )
    from multi_modal_gnn_tpu_torch.evaluation import evaluate_model
    from multi_modal_gnn_tpu_torch.tools import bench, bench_gather
    from multi_modal_gnn_tpu_torch.training import Trainer, masker_from_config, train_pipeline
    from multi_modal_gnn_tpu_torch.training.masker import _pad_batch
    from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, gpu_identity, require_cuda

    def reset_counts():
        sk.reset_launch_counts()
        pk.reset_launch_counts()
        ak.reset_launch_counts()
        gp.reset_launch_counts()

    def read_counts(names=RGCN_KERNELS):
        counts = {**sk.launch_counts, **pk.launch_counts}
        return {name: counts[name] for name in names}

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
    for label, entry in NAMED_KERNELS:
        print(f"    ptxas {label}: " + (" | ".join(_ptxas_report(_build.build_log, entry)) or "not built in this run"))
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

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

    # K1 on the other relations it aggregates (the paired tier's forward),
    # each against torch.sparse.mm; the largest above heads the JSON entry
    k1_rel = {}
    for et in sorted((et for et, t in tiers.items() if t in ("paired", "windowed") and et != et1),
                     key=lambda et: -graph.edges[et].num_valid):
        es = graph.edges[et]
        x = torch.randn(es.num_src, d, generator=gen).to(dev)
        csr = _csr(es.row_ptr, es.src, es.num_dst, es.num_src, dev)
        saved = results.pop("segment_sum_windowed")
        check(
            "segment_sum_windowed", et, x,
            lambda es=es, x=x: sk.segment_sum_windowed(x, es.win_src, es.win_local, es.win_tile_map, es.num_windows),
            lambda es=es, x=x: sk.segment_sum_windowed_plain(x, es.win_src, es.win_local, es.win_tile_map, es.num_windows),
            lambda csr=csr, x=x: torch.sparse.mm(csr, x),
            (es.win_src, es.win_local, es.win_tile_map),
        )
        k1_rel["/".join(et)] = results.pop("segment_sum_windowed")
        results["segment_sum_windowed"] = saved
    results["segment_sum_windowed"]["relations"] = {"/".join(et1): dict(results["segment_sum_windowed"]), **k1_rel}

    # K2f on the three fused-table relations, also with NaN rows past the
    # table (staged in shared memory, never read), timed in turns with
    # torch.sparse.mm (library, kernel, kernel, library); lab -> patient,
    # the largest, heads the kernel's JSON entry
    k2f = {}
    for et in sorted((et for et, t in tiers.items() if t == "fused_table"), key=lambda et: -graph.edges[et].num_valid):
        es = graph.edges[et]
        x = torch.randn(es.num_src, d, generator=gen).to(dev)
        csr = _csr(es.row_ptr, es.src, es.num_dst, es.num_src, dev)
        plan_t = (es.win_src, es.win_local, es.win_tile_map)
        kernel = lambda x=x, p=plan_t, es=es: sk.fused_table_segment_sum(x, *p, es.num_windows)  # noqa: E731
        plain = lambda x=x, p=plan_t, es=es: sk.fused_table_segment_sum_plain(x, *p, es.num_windows)  # noqa: E731
        library = lambda csr=csr, x=x: torch.sparse.mm(csr, x)  # noqa: E731
        name = f"fused_table_segment_sum on {'/'.join(et)}"
        want = mean_of(plain(), es)
        max_abs, _ = _compare(name, mean_of(kernel(), es), want, KERNEL_ATOL, KERNEL_RTOL)
        x_nan = torch.full((es.num_src + 37, d), float("nan"), device=dev)
        x_nan[: es.num_src] = x
        _compare(f"{name}, 37 NaN rows past the table",
                 mean_of(sk.fused_table_segment_sum(x_nan, *plan_t, es.num_windows), es), want,
                 KERNEL_ATOL, KERNEL_RTOL)
        del x_nan
        turns = [_median_ms(library), _median_ms(kernel), _median_ms(kernel), _median_ms(library)]
        ms, lib_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        bound = _bound(_nbytes(x, *plan_t) + es.num_windows * WINDOW * d * 4, es.num_valid * d)
        launch = sk.fused_table_launch(es.win_local.shape[0] // TILE_E, es.num_src, d, sms)
        plain_ms = _median_ms(plain)
        print(
            f"    {name}: turns library, kernel, kernel, library {', '.join('%.4f' % t for t in turns)} ms "
            f"(medians of {TIMING_REPS}); plain {plain_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}); {es.num_valid} edges\n      (K2f launch: {launch}; "
            f"{launch.shared_bytes} B of dynamic shared memory a block)"
        )
        k2f["/".join(et)] = {
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": lib_ms,
            "turns_ms": turns, "launch": dataclasses.asdict(launch),
        }
    largest = next(iter(k2f))
    results["fused_table_segment_sum"] = {**k2f[largest], "relation": largest, "relations": k2f}

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
    print(f"      (K3 launch: {sk.incidence_launch(es3.span_local.shape[0] // TILE_E, es3.span_rows, 1, d, sms, span=True)})")
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
    _phase("kernels", t0, "K1, K2f (NaN rows past the tables too), K3 match their plain versions")

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
    # K2b on the three fused-table relations (all six launches of a step),
    # each timed; the largest (lab -> patient) heads the kernel's JSON entry
    k2b = {}
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
        mirror = graph.edges[mirror_edge_type(et)]
        csr_t = _csr(mirror.row_ptr, mirror.src, mirror.num_dst, mirror.num_src, dev)
        timed(
            "fused_table_segment_sum_bwd",
            lambda g=g, args=args: sk.fused_table_segment_sum_bwd(g, *args),
            lambda g=g, args=args: sk.fused_table_segment_sum_bwd_plain(g, *args),
            lambda g=g, csr_t=csr_t: torch.sparse.mm(csr_t, g),
            _nbytes(g, *args[:3]) + es.num_src * d * 4, es.num_valid * d, max_abs,
        )
        k2b["/".join(et)] = results.pop("fused_table_segment_sum_bwd")
        launch = sk.incidence_launch(es.win_local.shape[0] // TILE_E, WINDOW, -(-es.num_src // WINDOW), d, sms)
        print(f"      (K2b on {'/'.join(et)}, {es.num_valid} edges; launch: {launch})")
    largest = next(iter(k2b))
    results["fused_table_segment_sum_bwd"] = {**k2b[largest], "relation": largest, "relations": k2b}

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

    def head_call(fn, rate, mask, *extra, params=None):
        return fn(
            *(head if params is None else params), batch.lab_idx, plan.win_local, plan.win_tile_map, seed,
            mask, plan.lab_block_map, rate, plan.lab_block_rows, *extra,
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
                floors = _head_fwd_floors(active[mname])
                print(f"      beside its bound: dropout hashes {floors['hash_ms']:.4f} ms, gathered rows "
                      f"{floors['gather_ms']:.4f} ms ({active[mname]} active slots)")
                timed(
                    "pair_head_bwd",
                    lambda m=mask: head_call(pk.pair_head_bwd, 0.2, m, plan.num_windows, g_out),
                    lambda m=mask: head_call(pk.pair_head_bwd_plain, 0.2, m, g_out), None,
                    head_bytes + _nbytes(g_out) + _nbytes(*head), active[mname] * HEAD_BWD_FLOPS,
                    bwd_err,
                )
            elif rate > 0:  # the tabular head's tiles: times and bounds beside the GNN head's entry
                tab_bytes = _nbytes(*head, batch.lab_idx, plan.win_local, plan.win_tile_map, mask,
                                    plan.lab_block_map)
                for name, fn, extra, nbytes, flops in (
                    ("pair_head_fwd", pk.pair_head_fwd, (), tab_bytes + plan.win_local.shape[0] * 4, HEAD_FWD_FLOPS),
                    ("pair_head_bwd", pk.pair_head_bwd, (plan.num_windows, g_out),
                     tab_bytes + _nbytes(g_out) + _nbytes(*head), HEAD_BWD_FLOPS),
                ):
                    ms = _median_ms(lambda m=mask, fn=fn, extra=extra: head_call(fn, 0.2, m, *extra))
                    bound = _bound(nbytes, active[mname] * flops)
                    floors = _head_fwd_floors(active[mname]) if name == "pair_head_fwd" else {}
                    print(f"    {name}, tabular head tiles: kernel {ms:.4f} ms  bound {bound['bound_ms']:.4f} ms "
                          f"({bound['bound_by']}, {active[mname]} active slots)"
                          + "".join(f"  {k} {v:.4f}" for k, v in floors.items()))
                    results[name]["tabular"] = {"ms": ms, **bound, "active_slots": active[mname]}
    # K4f without a tile mask, and with NaN rows past proj_l and past the
    # window-padded proj_p (never read)
    for rate in (0.0, 0.2):
        _compare(f"pair_head_fwd (rate {rate}, no tile mask)", head_call(pk.pair_head_fwd, rate, None),
                 head_call(pk.pair_head_fwd_plain, rate, None), HEAD_ATOL, HEAD_RTOL)
    nan_head = list(head)
    for i, rows in ((0, plan.num_windows * WINDOW + WINDOW), (1, num_l + 12)):
        nan_head[i] = torch.full((rows, 64), float("nan"), device=dev)
        nan_head[i][: head[i].shape[0]] = head[i]
    for mname, mask in masks.items():
        _compare(f"pair_head_fwd (rate 0.2, {mname} head tiles, NaN rows past the tables)",
                 head_call(pk.pair_head_fwd, 0.2, mask, params=nan_head),
                 head_call(pk.pair_head_fwd_plain, 0.2, mask), HEAD_ATOL, HEAD_RTOL)
    del nan_head
    print(f"      (K4f launch: {pk.fwd_launch(num_tiles, sms)})")
    print(f"      (K4b launch: {pk.bwd_launch(num_tiles, sms)})")

    # K4b at other lab counts (mimic_scale's 720, and 2048), over span@256
    # lab tiles and the full table: the train batch's patients with labs
    # drawn from a seed, laid out by the masker's own slot-major layout
    rows_p = batch_cpu.patient_idx[batch_cpu.valid > 0].numpy()
    lab_rng = np.random.default_rng(720)
    lab_batches, lab_counts, fwd_lab_counts = {}, {}, {}
    for num_l_x in LAB_COUNTS:
        labs_x = lab_rng.integers(0, num_l_x, rows_p.shape[0]).astype(np.int32)
        for rows_x in (256, 0):
            t_b = time.perf_counter()
            bx, _ = _pad_batch(rows_p, labs_x, np.zeros(rows_p.shape[0], np.float32), 256, num_p, num_l_x,
                               slot_major=True, lab_block_rows=rows_x)
            bx = bx.to(dev)
            lab_batches[(num_l_x, rows_x)] = bx
            px = bx.patient_plan
            lowx = (graph.patient_lab_degree[bx.patient_idx.long()] < config.model.degree_threshold).reshape(-1, TILE_E)
            gmask = (~lowx).any(dim=1).to(torch.int32)
            hx = [torch.randn(num_p, 64, generator=hg), torch.randn(num_l_x, 64, generator=hg)] + [
                t.cpu() for t in head[2:]]
            hx = [t.to(dev) for t in hx]
            realx = px.win_local < WINDOW
            gx = (torch.randn(px.win_local.shape[0], generator=hg).to(dev) * realx).contiguous()
            args_x = (bx.lab_idx, px.win_local, px.win_tile_map, seed, gmask, px.lab_block_map, 0.2, px.lab_block_rows)
            margin = pk.relu_margin_plain(*hx[:4], *args_x)
            g_safe = torch.where(margin > KINK_MARGIN, gx, torch.zeros_like(gx))
            tag = f"{num_l_x} labs, lab_tile_rows {rows_x}, rate 0.2, GNN head tiles"
            ferr, _ = _compare(f"pair_head_fwd ({tag})", pk.pair_head_fwd(*hx, *args_x),
                               pk.pair_head_fwd_plain(*hx, *args_x), HEAD_ATOL, HEAD_RTOL)
            fms = _median_ms(lambda hx=hx, args_x=args_x: pk.pair_head_fwd(*hx, *args_x))
            print(f"    pair_head_fwd ({tag}): kernel {fms:.4f} ms")
            fwd_lab_counts[f"{num_l_x} labs, lab_tile_rows {rows_x}"] = {"max_abs_err": ferr, "ms": fms}
            got = pk.pair_head_bwd(*hx, *args_x, px.num_windows, g_safe)
            want = pk.pair_head_bwd_plain(*hx, *args_x, g_safe)
            err = max(_compare_scaled(f"pair_head_bwd d{n} ({tag})", a, b, GRAD_REL) for n, a, b in zip(names, got, want))
            del got, want
            ms = _median_ms(lambda hx=hx, args_x=args_x, px=px, gx=gx: pk.pair_head_bwd(*hx, *args_x, px.num_windows, gx))
            print(f"    pair_head_bwd ({tag}): kernel {ms:.4f} ms; {px.win_local.shape[0] // TILE_E} tiles "
                  f"(batch laid out in {time.perf_counter() - t_b:.1f} s)")
            lab_counts[f"{num_l_x} labs, lab_tile_rows {rows_x}"] = {"max_abs_err": err, "ms": ms}
    results["pair_head_bwd"]["lab_counts"] = lab_counts
    results["pair_head_fwd"]["lab_counts"] = fwd_lab_counts
    _phase("train-kernels", t0, "K2b, K1 as a backward, K4f and K4b (500, 720 and 2048 labs) match their plain versions")

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
    # K1's call sites in this step, by the plan it runs on (ops/segment.py
    # calls it by that module's name)
    plan_of = {es.win_local.data_ptr(): et for et, es in graph.edges.items() if es.win_local is not None}
    k1_calls = []
    k1_real = seg_ops.segment_sum_windowed

    def k1_recorded(x, idx, win_local, win_tile_map, num_windows):
        k1_calls.append((plan_of.get(win_local.data_ptr()), idx is None))
        return k1_real(x, idx, win_local, win_tile_map, num_windows)

    seg_ops.segment_sum_windowed = k1_recorded
    try:
        t_step = time.perf_counter()
        loss = trainer.train_step(b_gpu, sup.to(dev), 0)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t_step
    finally:
        seg_ops.segment_sum_windowed = k1_real
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
    # K1 at each of the step's call sites, against its plain version (NaN rows
    # past the table too) and in turns with torch.sparse.mm (library,
    # kernel, kernel, library), each with its bound; the step's sum
    if len(k1_calls) != step_launches["segment_sum_windowed"] or any(et is None or g for et, g in k1_calls):
        raise AssertionError(f"K1 ran outside the graph's windowed plans: {k1_calls}")
    k1_sites, k1_step, k1_step_lib = {}, 0.0, 0.0
    for et in sorted(set(et for et, _ in k1_calls), key=lambda et: -graph.edges[et].num_valid):
        es, calls = graph.edges[et], sum(1 for e, _ in k1_calls if e == et)
        role = "forward" if tiers[et] in ("paired", "windowed") else f"backward of {'/'.join(mirror_edge_type(et))}"
        x = torch.randn(es.num_src, d, generator=gen).to(dev)
        args = (es.win_src, es.win_local, es.win_tile_map, es.num_windows)
        kernel = lambda x=x, args=args: sk.segment_sum_windowed(x, *args)  # noqa: E731
        want = mean_of(sk.segment_sum_windowed_plain(x, *args), es)
        name = f"K1 on the {'/'.join(et)} plan ({role}, {calls} a step)"
        max_abs, _ = _compare(name, mean_of(kernel(), es), want, KERNEL_ATOL, KERNEL_RTOL)
        x_nan = torch.full((es.num_src + 37, d), float("nan"), device=dev)
        x_nan[: es.num_src] = x
        _compare(f"{name}, 37 NaN rows past the table", mean_of(sk.segment_sum_windowed(x_nan, *args), es),
                 want, KERNEL_ATOL, KERNEL_RTOL)
        del x_nan
        csr = _csr(es.row_ptr, es.src, es.num_dst, es.num_src, dev)
        library = lambda csr=csr, x=x: torch.sparse.mm(csr, x)  # noqa: E731
        turns = [_median_ms(library), _median_ms(kernel), _median_ms(kernel), _median_ms(library)]
        ms, lib_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        bound = _bound(_nbytes(x, *args[:3]) + es.num_windows * WINDOW * d * 4, es.num_valid * d)
        route = sk.windowed_route(es.num_src, d)
        launch = sk.windowed_launch(es.win_local.shape[0] // TILE_E, es.num_src, d, sms, route)
        print(
            f"    {name}: route {route}; turns library, kernel, kernel, library "
            f"{', '.join('%.4f' % t for t in turns)} ms; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
            f"{es.num_valid} edges; launch {launch}"
        )
        k1_sites["/".join(et)] = {
            "role": role, "calls_per_step": calls, "route": route, "max_abs_err": max_abs, "ms": ms,
            **bound, "library_ms": lib_ms, "turns_ms": turns,
        }
        k1_step += calls * ms
        k1_step_lib += calls * lib_ms
    print(f"    K1 per step ({len(k1_calls)} launches): {k1_step:.4f} ms; torch.sparse.mm at the same sites {k1_step_lib:.4f} ms")
    results["segment_sum_windowed"].update(
        call_sites=k1_sites, per_step_ms=k1_step, per_step_library_ms=k1_step_lib,
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
    del model, trainer
    torch.cuda.empty_cache()

    # 10. hgt-graph --------------------------------------------------------
    t0 = time.perf_counter()
    hgt_config = dataclasses.replace(
        config, model=dataclasses.replace(config.model, architecture="HGT", num_heads=HGT_HEADS)
    )
    nh = HGT_HEADS
    graph_hgt_cpu = ensure_attn_plans(graph_cpu, hgt_config)
    plans_cpu = graph_hgt_cpu.attn_plans or {}
    for dst_t, plan in plans_cpu.items():
        sides = [
            f"{name} {side.num_windows} windows, "
            f"{f'span {side.span_rows}' if side.use_span else 'resident'}, "
            f"{side.arrays()[1].shape[0] // TILE_E} tiles"
            for name, side in (("fwd", plan.fwd), ("rev", plan.rev))
        ]
        print(
            f"    {dst_t}: {len(plan.rel_keys)} relations  E {plan.num_edges}  "
            f"virtual sources {plan.num_src_total}  " + "; ".join(sides)
        )
    if not {PATIENT, LAB} <= set(plans_cpu):
        raise AssertionError(f"no attention plan for the patient or lab group: {sorted(plans_cpu)}")
    graph_hgt = graph_hgt_cpu.to(dev)
    graph_seg = dataclasses.replace(graph_hgt, attn_plans=None)  # the segment tier
    plans = graph_hgt.attn_plans
    _phase("hgt-graph", t0, f"attention plans for {sorted(plans)}; a group without one runs the segment tier")

    # 11. hgt-kernels ------------------------------------------------------
    t0 = time.perf_counter()
    attn_results = {}

    def attn_problem(plan, seed):
        g = torch.Generator().manual_seed(seed)
        q = torch.randn(plan.num_dst, d, generator=g) / math.sqrt(d // nh)  # scaled, as the model's
        rows = [torch.randn(n, d, generator=g) for n in (plan.num_src_total,) * 2 + (plan.num_dst,)]
        return [t.to(dev) for t in (q, *rows)]

    def nan_padded(x, extra=4096):
        out = torch.full((x.shape[0] + extra, x.shape[1]), float("nan"), device=dev)
        out[: x.shape[0]] = x
        return out

    for seed, (dst_t, plan) in enumerate(sorted(plans.items(), key=lambda kv: -kv[1].num_edges)):
        q, k, v, dout = attn_problem(plan, 10 + seed)
        n, ns = plan.num_dst, plan.num_src_total
        # the forward side's tiles hold their slots in row order, as
        # ensure_attn_plans makes them for the model
        fwd_args = (*plan.fwd.arrays(), plan.fwd.num_windows, nh)
        rev_args = (*plan.rev.arrays(), plan.rev.num_windows, nh)
        tag = (f"{dst_t} group (fwd {'span' if plan.fwd.use_span else 'resident'}, "
               f"rev {'span' if plan.rev.use_span else 'resident'})")
        fwd_tiles = plan.fwd.arrays()[1].shape[0] // TILE_E
        launches = {
            "flash_attention_fwd": ak.fwd_launch(fwd_tiles, d, nh, sms),
            "flash_attention_dq": ak.dq_launch(fwd_tiles, d, nh, sms),
            "flash_attention_dkv": ak.dkv_launch(plan.rev.arrays()[1].shape[0] // TILE_E, n, d, nh, sms),
        }
        for name, launch in launches.items():
            print(f"      ({name} launch on the {dst_t} group: {launch})")
        out_p, lse_p = ak.flash_attention_fwd_plain(q, k, v, *fwd_args)
        lse_d = lse_p[:n].contiguous()
        delta = (dout * out_p[:n]).reshape(n, nh, -1).sum(-1).contiguous()
        stats = (q, k, v, dout, lse_d, delta)
        dq_p = ak.flash_attention_dq_plain(*stats, *fwd_args)
        dk_p, dv_p = ak.flash_attention_dkv_plain(*stats, *rev_args)
        # the kernels on the plain tables, then on tables with NaN rows past them
        errs = {}
        for label, (qx, kx, vx, dx) in (
            ("", (q, k, v, dout)),
            (", NaN rows past every table",
             (nan_padded(q)[:n], nan_padded(k), nan_padded(v), nan_padded(dout)[:n])),
        ):
            out, lse = ak.flash_attention_fwd(qx, kx, vx, *fwd_args)
            dq = ak.flash_attention_dq(qx, kx, vx, dx, lse_d, delta, *fwd_args)
            dk, dv = ak.flash_attention_dkv(qx, kx, vx, dx, lse_d, delta, *rev_args)
            torch.cuda.synchronize()
            errs.setdefault("flash_attention_fwd", []).extend([
                _compare(f"K6 out, {tag}{label}", out[:n], out_p[:n], KERNEL_ATOL, KERNEL_RTOL)[0],
                _compare(f"K6 lse, {tag}{label}", lse[:n], lse_p[:n], KERNEL_ATOL, KERNEL_RTOL)[0],
            ])
            errs.setdefault("flash_attention_dq", []).append(
                _compare_scaled(f"K7 dq, {tag}{label}", dq[:n], dq_p[:n], GRAD_REL)
            )
            errs.setdefault("flash_attention_dkv", []).extend([
                _compare_scaled(f"K8 dk, {tag}{label}", dk[:ns], dk_p[:ns], GRAD_REL),
                _compare_scaled(f"K8 dv, {tag}{label}", dv[:ns], dv_p[:ns], GRAD_REL),
            ])
            del out, lse, dq, dk, dv
        # the library yardstick: one scaled_dot_product_attention over the
        # group's dense additive mask, log(edge count) where a pair has edges,
        # -inf elsewhere (q arrives scaled: scale 1); its backward computes
        # K7's and K8's function together.  Built outside the timings.
        lib = _sdpa_yardstick(q, k, v, dout, *fwd_args, n, ns)
        real_rows = lse_p[:n, 0] < ak.EMPTY_LSE  # SDPA gives NaN on a row without edges
        _compare(f"SDPA ({lib['backend']}) out against K6's plain version, {tag}, rows with edges",
                 lib["out"][real_rows], out_p[:n][real_rows], SLICE_ATOL, SLICE_RTOL)
        # times in turns with the library (library, kernel, kernel, library) and bounds
        e = plan.num_edges
        fwd_plan, rev_plan = _nbytes(*plan.fwd.arrays()), _nbytes(*plan.rev.arrays())
        stats_bytes = _nbytes(q, k, v, dout, lse_d, delta)
        k6 = lambda: ak.flash_attention_fwd(q, k, v, *fwd_args)  # noqa: E731
        k7 = lambda: ak.flash_attention_dq(*stats, *fwd_args)  # noqa: E731
        k8 = lambda: ak.flash_attention_dkv(*stats, *rev_args)  # noqa: E731
        fwd_turns = [_median_ms(lib["fwd"]), _median_ms(k6), _median_ms(k6), _median_ms(lib["fwd"])]
        bwd_turns = [_median_ms(lib["bwd"]), _median_ms(k7), _median_ms(k8), _median_ms(k7), _median_ms(k8),
                     _median_ms(lib["bwd"])]
        lib_fwd, lib_bwd = (fwd_turns[0] + fwd_turns[3]) / 2, (bwd_turns[0] + bwd_turns[5]) / 2
        print(f"    {dst_t} group: turns SDPA forward, K6, K6, SDPA forward "
              f"{', '.join('%.4f' % t for t in fwd_turns)} ms; SDPA backward, K7, K8, K7, K8, SDPA backward "
              f"{', '.join('%.4f' % t for t in bwd_turns)} ms")
        work = {
            "flash_attention_fwd": (
                (fwd_turns[1] + fwd_turns[2]) / 2, fwd_turns,
                lambda: ak.flash_attention_fwd_plain(q, k, v, *fwd_args),
                _nbytes(q, k, v) + fwd_plan + _nbytes(out_p, lse_p), e * HGT_FWD_FLOPS_PER_COL * d, lib_fwd,
            ),
            "flash_attention_dq": (
                (bwd_turns[1] + bwd_turns[3]) / 2, bwd_turns,
                lambda: ak.flash_attention_dq_plain(*stats, *fwd_args),
                stats_bytes + fwd_plan + _nbytes(dq_p), e * HGT_BWD_FLOPS_PER_COL * d, lib_bwd,
            ),
            "flash_attention_dkv": (
                (bwd_turns[2] + bwd_turns[4]) / 2, bwd_turns,
                lambda: ak.flash_attention_dkv_plain(*stats, *rev_args),
                stats_bytes + rev_plan + _nbytes(dk_p, dv_p), e * HGT_BWD_FLOPS_PER_COL * d, lib_bwd,
            ),
        }
        for name, (ms, turns, plain, nbytes, flops, lib_ms) in work.items():
            plain_ms = _median_ms(plain, HGT_PLAIN_REPS)
            bound = _bound(nbytes, flops)
            covers = "K6" if name == "flash_attention_fwd" else "K7 + K8 together"
            print(
                f"    {name} on the {dst_t} group: kernel {ms:.4f} ms (mean of two medians of {TIMING_REPS})  "
                f"plain {plain_ms:.4f} ms (median of {HGT_PLAIN_REPS})  bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']})  library {lib_ms:.4f} ms (SDPA {lib['backend']}, {covers})"
            )
            attn_results.setdefault(name, {})[dst_t] = {
                "max_abs_err": max(errs[name]), "ms": ms, "plain_ms": plain_ms, **bound,
                "library_ms": lib_ms, "library_backend": lib["backend"], "library_covers": covers,
                "turns_ms": turns, "launch": dataclasses.asdict(launches[name]),
            }
        del lib, q, k, v, dout, out_p, lse_p, dq_p, dk_p, dv_p, stats, work, k6, k7, k8
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    _phase("hgt-kernels", t0, "K6, K7, K8 match their plain versions on every group, NaN rows past the tables too")

    # 12. hgt-slice --------------------------------------------------------
    t0 = time.perf_counter()
    model = build_model(hgt_config, graph_cpu, generator=torch.Generator().manual_seed(0))
    layer0 = model.hgt_0
    print("    tiers: " + ", ".join(f"{nt} {layer0.tier(graph_hgt, nt)}" for nt in layer0.groups()))
    reset_counts()
    t_state = time.perf_counter()
    state = compute_node_state(model, graph_hgt)
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t_state
    hgt_serving_launches = dict(ak.launch_counts)  # the HGT serving path ends here
    if not hgt_serving_launches["flash_attention_fwd"]:
        raise AssertionError(f"K6 did not launch on the HGT serving path: {hgt_serving_launches}")
    state_seg = compute_node_state(model, graph_seg)
    for key in ("final_p", "final_l"):
        _compare(f"HGT state[{key}], flash tier vs segment tier", state[key], state_seg[key], SLICE_ATOL, SLICE_RTOL)
    fn, _ = build_serving_fn(model, graph_hgt, state)
    fn_seg, _ = build_serving_fn(model, graph_seg, state_seg)
    patients = [int(x) for x in np.random.default_rng(1).integers(0, num_p, 3)]
    latencies = []
    for patient in patients:
        t_req = time.perf_counter()
        out = predict_patient(fn, patient, num_l)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t_req)
        _compare(f"HGT request, patient {patient} ({out.shape[0]} labs)", out, predict_patient(fn_seg, patient, num_l),
                 SLICE_ATOL, SLICE_RTOL)
    warm = []
    for _ in range(5):
        t_state = time.perf_counter()
        compute_node_state(model, graph_hgt)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t_state)
    _phase(
        "hgt-slice", t0,
        f"compute_node_state first call {state_s * 1e3:.1f} ms, steady median {statistics.median(warm) * 1e3:.2f} ms "
        f"(5 runs); 3 requests p50 {statistics.median(latencies) * 1e3:.3f} ms (first pass); "
        f"launches {hgt_serving_launches}",
    )
    del model, state, state_seg, fn, fn_seg
    torch.cuda.empty_cache()

    # 13. hgt-train-step ---------------------------------------------------
    t0 = time.perf_counter()
    hgt0 = dataclasses.replace(hgt_config, model=dataclasses.replace(hgt_config.model, dropout=0.0))
    hgt0_seg = dataclasses.replace(hgt0, model=dataclasses.replace(hgt0.model, extras={"hgt_flash": "off"}))
    sup = masker.supervision_mask(0, batch_cpu).to(dev)
    steps = {}
    for tier, cfg, g in (("flash", hgt0, graph_hgt), ("segment", hgt0_seg, graph_seg)):
        model = build_model(cfg, graph_cpu, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, g, masker, cfg)
        b = trainer.get_batch("train")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t_step = time.perf_counter()
        loss = trainer.train_step(b, sup, 0)
        torch.cuda.synchronize()
        steps[tier] = dict(
            loss=loss, ms=(time.perf_counter() - t_step) * 1e3,
            peak_gb=torch.cuda.max_memory_allocated() / 2**30, launches=dict(ak.launch_counts),
            grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            params={n: p.detach().cpu() for n, p in model.named_parameters()},
        )
        del model, trainer, b
        torch.cuda.empty_cache()
    flash, seg = steps["flash"], steps["segment"]
    if not all(flash["launches"].values()) or any(seg["launches"].values()):
        raise AssertionError(f"launches: flash tier {flash['launches']}, segment tier {seg['launches']}")
    _compare("HGT train step loss, flash vs segment tier", torch.tensor(flash["loss"]), torch.tensor(seg["loss"]),
             0.0, STEP_LOSS_RTOL)
    floor = STEP_GRAD_ZERO_FLOOR * max(float(g.norm()) for g in seg["grads"].values())
    failed_hgt = [
        name for name, g in seg["grads"].items()
        if not _compare_norm(f"HGT grad {name}", flash["grads"][name], g, HGT_STEP_GRAD_NORM_REL, floor)
    ]
    for name, p_seg in seg["params"].items():
        diff = float((flash["params"][name] - p_seg).abs().max())
        if diff > STEP_PARAM_ATOL:
            raise AssertionError(f"HGT param {name}: max |d| {diff:.3e} > {STEP_PARAM_ATOL}")
    if failed_hgt:
        raise AssertionError(f"HGT train-step gradients outside tolerance: {failed_hgt}")
    _phase(
        "hgt-train-step", t0,
        f"loss {flash['loss']:.6f} (segment tier {seg['loss']:.6f}); first step: flash "
        f"{flash['ms']:.1f} ms, peak {flash['peak_gb']:.2f} GiB; segment {seg['ms']:.1f} ms, peak "
        f"{seg['peak_gb']:.2f} GiB (torch.cuda.max_memory_allocated); launches {flash['launches']}",
    )
    del steps, flash, seg

    # 14. hgt-train --------------------------------------------------------
    t0 = time.perf_counter()
    model = build_model(hgt_config, graph_cpu, generator=torch.Generator().manual_seed(1))
    trainer = Trainer(model, graph_hgt, masker, hgt_config)
    trainer.train_epoch()  # warm-up
    trainer.epoch += 1
    torch.cuda.synchronize()
    reset_counts()
    hgt_epoch_ms, hgt_losses = [], []
    for _ in range(TRAIN_EPOCHS):
        t_ep = time.perf_counter()
        hgt_losses.append(trainer.train_epoch())
        torch.cuda.synchronize()
        hgt_epoch_ms.append((time.perf_counter() - t_ep) * 1e3)
        trainer.epoch += 1
    hgt_train_launches = dict(ak.launch_counts)  # the HGT training path ends here
    if not all(hgt_train_launches.values()):
        raise AssertionError(f"a kernel of the HGT training path did not launch: {hgt_train_launches}")
    if not all(np.isfinite(hgt_losses)):
        raise AssertionError(f"non-finite HGT training loss: {hgt_losses}")
    hgt_val = trainer.validate("val")
    if not np.isfinite(hgt_val):
        raise AssertionError(f"non-finite HGT validation loss {hgt_val}")
    hgt_edges_per_s = n_train * TRAIN_EPOCHS / (sum(hgt_epoch_ms) / 1e3)
    print(f"    losses {['%.6f' % x for x in hgt_losses]}  val loss {hgt_val:.6f}")
    print(f"    epoch ms {['%.2f' % x for x in hgt_epoch_ms]}  launches in {TRAIN_EPOCHS} epochs {hgt_train_launches}")
    wall_ms, busy_ms, top = _device_profile(trainer.train_epoch)
    print(
        f"    profiled epoch: wall {wall_ms:.2f} ms  device busy {busy_ms:.2f} ms  "
        f"idle share {max(0.0, 1 - busy_ms / wall_ms):.4f}"
    )
    for name, ms in top[:12]:
        print(f"      {ms:9.3f} ms  {100 * ms / max(busy_ms, 1e-9):5.1f} %  {name[:130]}")
    _phase(
        "hgt-train", t0,
        f"{TRAIN_EPOCHS} epochs, dropout {hgt_config.model.dropout}: median epoch "
        f"{statistics.median(hgt_epoch_ms):.2f} ms  train_patient_lab_edges_per_sec {hgt_edges_per_s:.1f} "
        f"({n_train} train rows)",
    )

    del model, trainer
    torch.cuda.empty_cache()

    # 15. dual-kernels -----------------------------------------------------
    t0 = time.perf_counter()
    dual_config = dataclasses.replace(
        config,
        model=dataclasses.replace(config.model, extras={"dual_head_fusion": "on"}),
        train=dataclasses.replace(config.train, extras={"lab_tile_rows": 0}),
    )
    masker0 = masker_from_config(dual_config, graph_cpu)
    batch0_cpu = masker0.get_split("train")
    if not (batch0_cpu.patient_plan.identity and batch0_cpu.patient_plan.lab_block_rows == 0):
        raise AssertionError("the lab_tile_rows 0 train batch is not slot-major over the full lab table")
    batch0 = batch0_cpu.to(dev)
    plan0 = batch0.patient_plan
    slots0 = plan0.win_local.shape[0]
    low0 = (graph.patient_lab_degree[batch0.patient_idx.long()] < config.model.degree_threshold).reshape(
        -1, TILE_E
    )
    masks0 = {"tab": low0.any(dim=1).to(torch.int32), "gnn": (~low0).any(dim=1).to(torch.int32)}
    real0 = plan0.win_local < WINDOW
    active0 = {k: int((real0.reshape(-1, TILE_E) & (m[:, None] != 0)).sum()) for k, m in masks0.items()}
    either0 = float(((masks0["tab"] != 0) | (masks0["gnn"] != 0)).float().mean())
    print(
        f"    train batch, lab_tile_rows 0: rows {batch0.num_valid}  slots {slots0} "
        f"({slots0 / batch0.num_valid:.3f}x)  tiles {slots0 // TILE_E}  windows {plan0.num_windows}  "
        f"tiles run: GNN head {float(masks0['gnn'].float().mean()):.4f}, tabular head "
        f"{float(masks0['tab'].float().mean()):.4f}, either {either0:.4f}  active slots "
        f"GNN {active0['gnn']}, tabular {active0['tab']}"
    )
    hg = torch.Generator().manual_seed(2)

    def rand_head(b2):
        return [
            torch.randn(num_p, 64, generator=hg), torch.randn(num_l, 64, generator=hg),
            torch.randn(64, 32, generator=hg) * 0.1, torch.randn(32, generator=hg) * 0.1,
            torch.randn(32, generator=hg) * 0.1, torch.tensor([b2]),
        ]

    dual_params = [h.to(dev) for h in rand_head(0.3) + rand_head(-0.2)]
    g_dual = [(torch.randn(slots0, generator=hg).to(dev) * real0).contiguous() for _ in range(2)]
    seed4 = (2024, 7, 99, 13)
    both_masks = (masks0["tab"], masks0["gnn"])

    def dual_call(fn, params, rate, masks, *extra):
        return fn(
            *params, batch0.lab_idx, plan0.win_local, plan0.win_tile_map, seed4, *masks, rate, *extra
        )

    def dual_safe_grads(params, rate, masks):
        margins = dual_call(pk.relu_margin_dual_plain, params[0:4] + params[6:10], rate, masks)
        near = [int(((m <= KINK_MARGIN) & (m != 0)).sum()) for m in margins]
        print(f"    {near[0]} tabular and {near[1]} GNN active slots lie within {KINK_MARGIN:g} of a "
              f"ReLU kink: kept out of the backward check")
        return [torch.where(m > KINK_MARGIN, g, torch.zeros_like(g)) for m, g in zip(margins, g_dual)]

    dual_names = [f"{h}.{n}" for h in ("tab", "gnn") for n in names]
    dual_errs = {"pair_head_dual_fwd": [], "pair_head_dual_bwd": []}
    for rate in (0.0, 0.2):
        for mname, m in (("both heads' masks", both_masks), ("no masks", (None, None))):
            tag = f"rate {rate}, {mname}"
            got = dual_call(pk.pair_head_dual_fwd, dual_params, rate, m)
            want = dual_call(pk.pair_head_dual_fwd_plain, dual_params, rate, m)
            dual_errs["pair_head_dual_fwd"] += [
                _compare(f"pair_head_dual_fwd {h} ({tag})", a, b, HEAD_ATOL, HEAD_RTOL)[0]
                for h, a, b in zip(("tab", "gnn"), got, want)
            ]
            g_safe = dual_safe_grads(dual_params, rate, m)
            got = dual_call(pk.pair_head_dual_bwd, dual_params, rate, m, plan0.num_windows, *g_safe)
            want = dual_call(pk.pair_head_dual_bwd_plain, dual_params, rate, m, *g_safe)
            dual_errs["pair_head_dual_bwd"] += [
                _compare_scaled(f"pair_head_dual_bwd d{n} ({tag})", a, b, GRAD_REL)
                for n, a, b in zip(dual_names, got, want)
            ]
            del got, want
    # NaN rows past proj_l and past the window-padded proj_p: never read
    nan_params = []
    for i, x in enumerate(dual_params):
        if i % 6 in (0, 1):
            rows = plan0.num_windows * WINDOW + WINDOW if i % 6 == 0 else num_l + 12
            padded = torch.full((rows, 64), float("nan"), device=dev)
            padded[: x.shape[0]] = x
            x = padded
        nan_params.append(x)
    g_safe = dual_safe_grads(dual_params, 0.2, both_masks)
    got = dual_call(pk.pair_head_dual_fwd, nan_params, 0.2, both_masks)
    want = dual_call(pk.pair_head_dual_fwd_plain, dual_params, 0.2, both_masks)
    for h, a, b in zip(("tab", "gnn"), got, want):
        _compare(f"pair_head_dual_fwd {h}, NaN rows past the tables", a, b, HEAD_ATOL, HEAD_RTOL)
    got = dual_call(pk.pair_head_dual_bwd, nan_params, 0.2, both_masks, plan0.num_windows, *g_safe)
    want = dual_call(pk.pair_head_dual_bwd_plain, dual_params, 0.2, both_masks, *g_safe)
    for i, (n, a, b) in enumerate(zip(dual_names, got, want)):
        if i % 6 in (0, 1):
            if float(a[b.shape[0]:].abs().sum()) != 0.0:
                raise AssertionError(f"pair_head_dual_bwd d{n}: rows past the table are not 0")
            a = a[: b.shape[0]]
        _compare_scaled(f"pair_head_dual_bwd d{n}, NaN rows past the tables", a, b, GRAD_REL)
    del got, want, nan_params
    # K5f with the tabular head masked on every tile: its output is 0
    no_tab = (torch.zeros_like(masks0["tab"]), masks0["gnn"])
    got = dual_call(pk.pair_head_dual_fwd, dual_params, 0.2, no_tab)
    want = dual_call(pk.pair_head_dual_fwd_plain, dual_params, 0.2, no_tab)
    if float(got[0].abs().sum()) != 0.0:
        raise AssertionError("pair_head_dual_fwd: a head masked on every tile output non-zeros")
    for h, a, b in zip(("tab", "gnn"), got, want):
        _compare(f"pair_head_dual_fwd {h}, tabular head masked on every tile", a, b, HEAD_ATOL, HEAD_RTOL)
    del got, want
    # K5f and K5b at 720 and 2048 labs (phase 7's full-table batches), both
    # heads' masks, dropout 0.2
    dual_lab_counts, dual_fwd_lab_counts = {}, {}
    for num_l_x in LAB_COUNTS:
        bx = lab_batches[(num_l_x, 0)]
        px = bx.patient_plan
        lowx = (graph.patient_lab_degree[bx.patient_idx.long()] < config.model.degree_threshold).reshape(-1, TILE_E)
        mx = (lowx.any(dim=1).to(torch.int32), (~lowx).any(dim=1).to(torch.int32))
        px_params = []
        for h in (0, 6):
            px_params += [torch.randn(num_p, 64, generator=hg).to(dev), torch.randn(num_l_x, 64, generator=hg).to(dev)]
            px_params += dual_params[h + 2 : h + 6]
        realx = px.win_local < WINDOW
        gx = [(torch.randn(px.win_local.shape[0], generator=hg).to(dev) * realx).contiguous() for _ in range(2)]
        xcall = lambda fn, params, *extra, bx=bx, px=px, mx=mx: fn(  # noqa: E731
            *params, bx.lab_idx, px.win_local, px.win_tile_map, seed4, *mx, 0.2, *extra)
        margins = xcall(pk.relu_margin_dual_plain, px_params[0:4] + px_params[6:10])
        g_safe = [torch.where(m > KINK_MARGIN, g, torch.zeros_like(g)) for m, g in zip(margins, gx)]
        tag = f"{num_l_x} labs, rate 0.2, both heads' masks"
        ferr = max(_compare(f"pair_head_dual_fwd {h} ({tag})", a, b, HEAD_ATOL, HEAD_RTOL)[0] for h, a, b in
                   zip(("tab", "gnn"), xcall(pk.pair_head_dual_fwd, px_params), xcall(pk.pair_head_dual_fwd_plain, px_params)))
        fms = _median_ms(lambda xcall=xcall, p=px_params: xcall(pk.pair_head_dual_fwd, p))
        print(f"    pair_head_dual_fwd ({tag}): kernel {fms:.4f} ms")
        dual_fwd_lab_counts[f"{num_l_x} labs"] = {"max_abs_err": ferr, "ms": fms}
        got = xcall(pk.pair_head_dual_bwd, px_params, px.num_windows, *g_safe)
        want = xcall(pk.pair_head_dual_bwd_plain, px_params, *g_safe)
        err = max(_compare_scaled(f"pair_head_dual_bwd d{n} ({tag})", a, b, GRAD_REL)
                  for n, a, b in zip(dual_names, got, want))
        del got, want
        ms = _median_ms(lambda xcall=xcall, p=px_params, px=px, gx=gx: xcall(pk.pair_head_dual_bwd, p, px.num_windows, *gx))
        print(f"    pair_head_dual_bwd ({tag}): kernel {ms:.4f} ms; {px.win_local.shape[0] // TILE_E} tiles")
        dual_lab_counts[f"{num_l_x} labs"] = {"max_abs_err": err, "ms": ms}
    del lab_batches
    print(f"      (K5f launch: {pk.fwd_launch(slots0 // TILE_E, sms, heads=2)})")
    print(f"      (K5b launch: {pk.bwd_launch(slots0 // TILE_E, sms, heads=2)})")
    # times: K5f / K5b against K4f / K4b of both heads, same batch, dropout 0.2, masks
    k4_heads = (
        (dual_params[:6], seed4[:2], masks0["tab"], g_dual[0]),
        (dual_params[6:], seed4[2:], masks0["gnn"], g_dual[1]),
    )

    def k4_both(backward: bool):
        for head, seed, mask, g in k4_heads:
            plan_args = (batch0.lab_idx, plan0.win_local, plan0.win_tile_map, seed, mask, None, 0.2, 0)
            if backward:
                pk.pair_head_bwd(*head, *plan_args, plan0.num_windows, g)
            else:
                pk.pair_head_fwd(*head, *plan_args)

    dual_bytes = _nbytes(*dual_params, batch0.lab_idx, plan0.win_local, plan0.win_tile_map, *both_masks)
    dual_active = sum(active0.values())  # each head's real slots in its unmasked tiles
    timed(
        "pair_head_dual_fwd", lambda: dual_call(pk.pair_head_dual_fwd, dual_params, 0.2, both_masks),
        lambda: dual_call(pk.pair_head_dual_fwd_plain, dual_params, 0.2, both_masks), None,
        dual_bytes + 2 * slots0 * 4, dual_active * HEAD_FWD_FLOPS, max(dual_errs["pair_head_dual_fwd"]),
    )
    floors = _head_fwd_floors(dual_active)
    results["pair_head_dual_fwd"].update(lab_counts=dual_fwd_lab_counts)
    print(f"      beside its bound: dropout hashes {floors['hash_ms']:.4f} ms, gathered rows "
          f"{floors['gather_ms']:.4f} ms ({dual_active} active slots of both heads)")
    timed(
        "pair_head_dual_bwd",
        lambda: dual_call(pk.pair_head_dual_bwd, dual_params, 0.2, both_masks, plan0.num_windows, *g_dual),
        lambda: dual_call(pk.pair_head_dual_bwd_plain, dual_params, 0.2, both_masks, *g_dual), None,
        dual_bytes + _nbytes(*g_dual) + _nbytes(*dual_params), dual_active * HEAD_BWD_FLOPS,
        max(dual_errs["pair_head_dual_bwd"]),
    )
    k4_fwd_ms = _median_ms(lambda: k4_both(False))
    k4_bwd_ms = _median_ms(lambda: k4_both(True))
    results["pair_head_dual_fwd"]["k4_both_heads_ms"] = k4_fwd_ms
    results["pair_head_dual_bwd"]["k4_both_heads_ms"] = k4_bwd_ms
    results["pair_head_dual_bwd"]["lab_counts"] = dual_lab_counts
    print(
        f"    same batch, same call: K5f {results['pair_head_dual_fwd']['ms']:.4f} ms vs K4f tabular + GNN "
        f"{k4_fwd_ms:.4f} ms; K5b {results['pair_head_dual_bwd']['ms']:.4f} ms vs K4b tabular + GNN "
        f"{k4_bwd_ms:.4f} ms (medians of {TIMING_REPS})"
    )
    del dual_params, g_dual, g_safe
    torch.cuda.empty_cache()
    _phase("dual-kernels", t0, "K5f and K5b (500, 720 and 2048 labs) match their plain versions, NaN rows past the tables and a head masked on every tile too")

    # 16. dual-train-step --------------------------------------------------
    t0 = time.perf_counter()
    sup0 = masker0.supervision_mask(0, batch0_cpu).to(dev)
    dual_steps = {}
    for mode in ("on", "off"):
        cfg = dataclasses.replace(
            dual_config,
            model=dataclasses.replace(dual_config.model, dropout=0.0, extras={"dual_head_fusion": mode}),
        )
        model = build_model(cfg, graph_cpu, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, graph, masker0, cfg)
        b = trainer.get_batch("train")
        torch.cuda.synchronize()
        reset_counts()
        t_step = time.perf_counter()
        loss = trainer.train_step(b, sup0, 0)
        torch.cuda.synchronize()
        dual_steps[mode] = dict(
            loss=loss, ms=(time.perf_counter() - t_step) * 1e3,
            launches=read_counts(HEAD_PATH_KERNELS),
            grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            params={n: p.detach().cpu() for n, p in model.named_parameters()},
        )
        del model, trainer, b
    on, off = dual_steps["on"], dual_steps["off"]
    heads = {"on": ("pair_head_dual_fwd", "pair_head_dual_bwd"), "off": ("pair_head_fwd", "pair_head_bwd")}
    for mode, other in (("on", "off"), ("off", "on")):
        counts = dual_steps[mode]["launches"]
        if not (all(counts[k] for k in (*SEGMENT_KERNELS, *heads[mode])) and not any(counts[k] for k in heads[other])):
            raise AssertionError(f"dual_head_fusion {mode}: launches {counts}")
    _compare("dual train step loss, on vs off", torch.tensor(on["loss"]), torch.tensor(off["loss"]), 0.0,
             STEP_LOSS_RTOL)
    floor = STEP_GRAD_ZERO_FLOOR * max(float(g.norm()) for g in off["grads"].values())
    failed_dual = [
        name for name, g in off["grads"].items()
        if not _compare_norm(f"dual grad {name}", on["grads"][name], g, STEP_GRAD_NORM_REL, floor)
    ]
    for name, p_off in off["params"].items():
        diff = float((on["params"][name] - p_off).abs().max())
        if diff > STEP_PARAM_ATOL:
            raise AssertionError(f"dual param {name}: max |d| {diff:.3e} > {STEP_PARAM_ATOL}")
    if failed_dual:
        raise AssertionError(f"dual train-step gradients outside tolerance: {failed_dual}")
    _phase(
        "dual-train-step", t0,
        f"loss {on['loss']:.6f} (off {off['loss']:.6f}); first step on {on['ms']:.1f} ms, off {off['ms']:.1f} ms; "
        f"launches on {on['launches']}, off {off['launches']}",
    )
    del dual_steps, on, off
    torch.cuda.empty_cache()

    # 17. dual-train -------------------------------------------------------
    t0 = time.perf_counter()

    off_config = dataclasses.replace(
        dual_config, model=dataclasses.replace(dual_config.model, extras={"dual_head_fusion": "off"})
    )
    runs = {  # label: (config, masker); their epochs run in turns, one each a round
        "on, lab_tile_rows 0": (dual_config, masker0),
        "off, lab_tile_rows 0": (off_config, masker0),
        "default, span@256": (config, masker),
    }
    trainers, epoch_ms, losses, launches = {}, {}, {}, {}
    for label, (cfg, m) in runs.items():
        trainers[label] = Trainer(build_model(cfg, graph_cpu, generator=torch.Generator().manual_seed(1)), graph, m, cfg)
        trainers[label].train_epoch()  # warm-up
        trainers[label].epoch += 1
        epoch_ms[label], losses[label], launches[label] = [], [], dict.fromkeys(HEAD_PATH_KERNELS, 0)
    torch.cuda.synchronize()
    order = list(runs)
    for r in range(TRAIN_EPOCHS):
        for label in order if r % 2 == 0 else order[::-1]:  # ABC CBA ...
            reset_counts()
            t_ep = time.perf_counter()
            losses[label].append(trainers[label].train_epoch())
            torch.cuda.synchronize()
            epoch_ms[label].append((time.perf_counter() - t_ep) * 1e3)
            trainers[label].epoch += 1
            for k, v in read_counts(HEAD_PATH_KERNELS).items():
                launches[label][k] += v
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite training loss: {losses}")
    dual_label = order[0]
    dual_launches, dual_epoch_ms, trainer = launches[dual_label], epoch_ms[dual_label], trainers[dual_label]
    if not all(dual_launches[k] for k in DUAL_KERNELS) or dual_launches["pair_head_fwd"] or dual_launches["pair_head_bwd"]:
        raise AssertionError(f"the dual training path's launches: {dual_launches}")
    for label in order[1:]:
        if not all(launches[label][k] for k in RGCN_KERNELS) or launches[label]["pair_head_dual_fwd"]:
            raise AssertionError(f"{label}: launches {launches[label]}")
    dual_val = trainer.validate("val")
    reset_counts()
    dual_train_eval = trainer.validate("train")  # the eval step over the slot-major batch
    eval_launches = read_counts(("pair_head_dual_fwd", "pair_head_fwd"))
    if eval_launches != {"pair_head_dual_fwd": 1, "pair_head_fwd": 0} or not np.isfinite([dual_val, dual_train_eval]).all():
        raise AssertionError(f"eval step: launches {eval_launches}, losses {dual_val}, {dual_train_eval}")
    dual_edges_per_s = n_train * TRAIN_EPOCHS / (sum(dual_epoch_ms) / 1e3)
    print(f"    on: losses {['%.6f' % x for x in losses[dual_label]]}  val loss {dual_val:.6f}  "
          f"eval loss over the train batch {dual_train_eval:.6f} (launches {eval_launches})")
    for label in order:
        print(f"    {label}: epoch ms {['%.2f' % x for x in epoch_ms[label]]}  launches in {TRAIN_EPOCHS} epochs {launches[label]}")
    wall_ms, busy_ms, top = _device_profile(trainer.train_epoch)
    print(
        f"    on, profiled epoch: wall {wall_ms:.2f} ms  device busy {busy_ms:.2f} ms  "
        f"idle share {max(0.0, 1 - busy_ms / wall_ms):.4f}"
    )
    for name, ms in top[:12]:
        print(f"      {ms:9.3f} ms  {100 * ms / max(busy_ms, 1e-9):5.1f} %  {name[:130]}")
    del trainer, trainers
    epoch_medians = {label: statistics.median(v) for label, v in epoch_ms.items()}
    _phase(
        "dual-train", t0,
        f"{TRAIN_EPOCHS} epochs each in turns, dropout {config.model.dropout}; median epoch: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in epoch_medians.items())
        + f"; on: train_patient_lab_edges_per_sec {dual_edges_per_s:.1f} ({n_train} train rows)",
    )
    torch.cuda.empty_cache()

    # 18. gather-probe -----------------------------------------------------
    t0 = time.perf_counter()
    gp.reset_launch_counts()
    tool = bench_gather.main([])  # the tool at the script's defaults
    probe_launches = dict(gp.launch_counts)  # the probe's path ends here
    if not all(probe_launches.values()):
        raise AssertionError(f"a kernel of the gather probe did not launch: {probe_launches}")
    probe_results = {}
    for h in (64, 128):
        args = bench_gather.parse_args(["--h", str(h)])
        idx, table, padded = (torch.from_numpy(a).to(dev) for a in bench_gather.make_inputs(args))
        n_slots = idx.shape[0]
        # kernel, its table, library call, FLOPs of the function (each slot's
        # row sum); A's one-hot product does rows times that work, reported
        # apart as onehot_ops_ms and not used as its bound
        work = {
            "gather_probe_indicator": (
                lambda: gp.gather_probe_indicator(idx, table), table,
                lambda: torch.index_select(table, 0, idx).sum(1), float(n_slots * h),
            ),
            "gather_probe_padded": (
                lambda: gp.gather_probe_padded(idx, padded, h), padded,
                lambda: torch.index_select(padded, 0, idx)[:, :h].sum(1), float(n_slots * h),
            ),
            "gather_probe_direct": (
                lambda: gp.gather_probe_direct(idx, table), table,
                lambda: torch.index_select(table, 0, idx).sum(1), float(n_slots * h),
            ),
        }
        for name, (kernel, tbl, library, flops) in work.items():
            plain = lambda tbl=tbl: gp.gather_rowsum_plain(idx, tbl, h)  # noqa: E731
            err = _compare_scaled(f"{name}, H {h}", kernel(), plain(), 1e-5)
            ms, plain_ms = _median_ms(kernel), _median_ms(plain)
            bound = _bound(_nbytes(idx, tbl) + n_slots * 4, flops)
            if name == "gather_probe_indicator":
                bound["onehot_ops_ms"] = 2.0 * n_slots * args.rows * h / FP32_FLOPS * 1e3
                layout = f"  one-hot product's operations {bound['onehot_ops_ms']:.4f} ms"
            else:
                layout = "  table in shared memory" if gp.direct_staged(*tbl.shape) else "  table through L2"
            print(
                f"    {name}, H {h}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']}){layout}"
            )
            probe_results.setdefault(name, {})[h] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
                "library_ms": _library_ms(f"{name} (index_select + sum), H {h}", library),
            }
        del idx, table, padded, work
    _phase(
        "gather-probe", t0,
        "bench_gather at the script's defaults: " + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in tool.items())
        + f"; launches {probe_launches}",
    )

    # 19. bench ------------------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    reset_counts()
    bench_line = bench.run_bench(scale=True, dense=False, quick=True)
    bench_launches = read_counts()  # the bench's path ends here
    print(json.dumps(bench_line), flush=True)
    timed = bench_line["kernel_launches"]
    if not (math.isfinite(bench_line["value"]) and bench_line["value"] > 0):
        raise AssertionError(f"bench value {bench_line['value']!r} is not finite and positive")
    if torch.cuda.get_device_name(0) not in bench_line["device"]:
        raise AssertionError(f"bench device {bench_line['device']!r} does not name the card")
    if not all(timed.get(name, 0) > 0 for name in RGCN_KERNELS):
        raise AssertionError(f"a kernel of the RGCN path did not launch in the timed chunks: {timed}")
    _phase(
        "bench", t0,
        f"train_patient_lab_edges_per_sec {bench_line['value']:.1f}, epoch {bench_line['epoch_time_ms']:.3f} ms, "
        f"warm-up {bench_line['warmup_s']:.2f} s, graph build {bench_line['graph_build_s']:.2f} s; "
        f"launches in the timed chunks {timed}",
    )

    # 20. lifecycle --------------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    life_config = dataclasses.replace(
        config,
        train=dataclasses.replace(config.train, epochs=LIFECYCLE_EPOCHS),
        logging=dataclasses.replace(config.logging, checkpoint_interval=2),
        evaluation=dataclasses.replace(
            config.evaluation, baselines=("global_mean", "per_lab_mean"), extras={"conformal_alpha": 0.1},
        ),
    )
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        runs = {}
        for label in ("unbroken", "unbroken again"):
            run_t = time.perf_counter()
            trainer, pipeline_results = train_pipeline(life_config, graph, tmp / label)
            runs[label] = (list(trainer.history["train_loss"]), list(trainer.history["val_loss"]))
            print(
                f"    {label}: {time.perf_counter() - run_t:.1f} s  train {runs[label][0]}  "
                f"val {runs[label][1]}  test loss of the best state {pipeline_results['test_loss']:.6f}"
            )
            if label == "unbroken":
                unbroken = trainer
            del trainer
        # a fresh trainer resumes from the unbroken run's own epoch-2 checkpoint
        (tmp / "resumed").mkdir()
        for name in ("checkpoint_epoch_2.ckpt", "checkpoint_epoch_2.ckpt.json"):
            shutil.copy(tmp / "unbroken" / name, tmp / "resumed" / name)
        model = build_model(life_config, graph_cpu, generator=torch.Generator().manual_seed(5))
        resumed = Trainer(model, graph, masker_from_config(life_config, graph), life_config)
        resumed.fit(output_dir=tmp / "resumed", resume_from="auto")
        runs["resumed"] = (list(resumed.history["train_loss"]), list(resumed.history["val_loss"]))
        print(f"    resumed from checkpoint_epoch_2.ckpt: train {runs['resumed'][0]}  val {runs['resumed'][1]}")
        # a planted fault the tolerance must catch: a resume that loses the
        # Adam state (moments and step count) after the restore
        faulty = Trainer(model, graph, masker_from_config(life_config, graph), life_config)
        faulty.restore(tmp / "resumed" / "checkpoint_epoch_2.ckpt")
        faulty.optimizer.state.clear()
        faulty.fit(output_dir=tmp / "faulty")
        runs["faulty"] = (list(faulty.history["train_loss"]), list(faulty.history["val_loss"]))
        print(f"    resumed with the Adam state dropped: train {runs['faulty'][0]}  val {runs['faulty'][1]}")
        del resumed, faulty, model

        def rel_drift(a, b):  # over epochs 3 on, train and val losses
            return max(abs(x - y) / abs(y) for la, lb in zip(a, b) for x, y in zip(la[2:], lb[2:]))

        drift = rel_drift(runs["unbroken again"], runs["unbroken"])
        tolerance = 2 * drift
        resume_drift = rel_drift(runs["resumed"], runs["unbroken"])
        if len(runs["resumed"][0]) != LIFECYCLE_EPOCHS or not resume_drift <= tolerance:
            raise AssertionError(
                f"resumed epochs 3-{LIFECYCLE_EPOCHS} differ from the unbroken run by {resume_drift:.3e} "
                f"(relative), over the tolerance {tolerance:.3e} (twice the unbroken runs' drift {drift:.3e})"
            )
        fault_drift = rel_drift(runs["faulty"], runs["unbroken"])
        if not fault_drift > tolerance:
            raise AssertionError(
                f"a resume that drops the Adam state differs from the unbroken run by {fault_drift:.3e}, "
                f"within the tolerance {tolerance:.3e}: the check cannot tell a faulty resume"
            )
        tmp_unbroken = tmp / "unbroken"
        unbroken.load_best_model(tmp_unbroken)
        evaluation = evaluate_model(unbroken, graph, life_config, output_dir=tmp_unbroken)
        artifacts = (
            "best_model.ckpt", "best_model.ckpt.json", "checkpoint_epoch_2.ckpt", "checkpoint_epoch_4.ckpt",
            "metrics.jsonl", "training_history.json", "test_results.json", "evaluation_results.json",
            "per_lab_metrics.csv", "conformal.json",
        )
        missing = [name for name in artifacts if not (tmp_unbroken / name).exists()]
        if missing:
            raise AssertionError(f"artifacts missing after the lifecycle: {missing}")
        metrics = [
            *evaluation["overall_metrics"].values(), *evaluation["raw_metrics"].values(),
            *(v for m in evaluation["baselines"].values() for v in m.values()),
            evaluation["conformal"]["coverage"], evaluation["conformal"]["mean_width"],
        ]
        if not all(math.isfinite(v) for v in metrics):
            raise AssertionError(f"non-finite evaluation metrics: {evaluation}")
        test_p, test_l, _ = unbroken.masker.split_arrays("test")
        pick = np.random.default_rng(0).choice(len(test_p), PAIRS_CHECKED, replace=False)
        pairs = unbroken.predict_pairs(test_p[pick], test_l[pick], state=unbroken.best_state)
        pairs_err, _ = _compare(
            "predict_pairs against predict('test')", torch.from_numpy(pairs),
            torch.from_numpy(unbroken.predict("test", unbroken.best_state)[pick]), 1e-5, 0.0,
        )
        del unbroken
    lifecycle_launches = read_counts()  # the lifecycle's path ends here
    if not all(lifecycle_launches.values()):
        raise AssertionError(f"a kernel of the RGCN path did not launch in the lifecycle: {lifecycle_launches}")
    conf = evaluation["conformal"]
    print(
        f"    evaluation of the best state: MAE {evaluation['overall_metrics']['mae']:.6f}  "
        f"R2 {evaluation['overall_metrics']['r2']:.6f}  baselines "
        + ", ".join(f"{k} MAE {v['mae']:.6f}" for k, v in evaluation["baselines"].items())
        + f"  conformal coverage {conf['coverage']:.4f} (target {conf['target_coverage']:.2f}), "
        f"mean width {conf['mean_width']:.4f}"
    )
    torch.cuda.empty_cache()
    _phase(
        "lifecycle", t0,
        f"train_pipeline {LIFECYCLE_EPOCHS} epochs x 2 and a resume from the first's epoch 2: the two differ "
        f"by {drift:.3e} (relative, train and val losses of epochs 3-{LIFECYCLE_EPOCHS}), so the tolerance is "
        f"{tolerance:.3e}; the resumed "
        f"epochs 3-{LIFECYCLE_EPOCHS} differ by {resume_drift:.3e}, a resume that drops the Adam state by "
        f"{fault_drift:.3e}; {len(artifacts)} artifacts; "
        f"predict_pairs on {PAIRS_CHECKED} test pairs within {pairs_err:.2e} of predict; launches {lifecycle_launches}",
    )

    # 21. pipeline ---------------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    from multi_modal_gnn_tpu_torch import pipeline
    from multi_modal_gnn_tpu_torch.tools import flagship_band
    import multi_modal_gnn_tpu_torch.training.masker as masker_mod

    repo = Path(__file__).resolve().parent
    flagship = repo / "conf" / "eicu_real.yaml"
    guarded = {name: _tree_state(repo / name) for name in ("outputs", "data")}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for seed in FLAGSHIP_SEEDS:
            runs[seed] = flagship_band.run_seed(flagship, seed, tmp / f"seed{seed}", device="cuda")
            run = runs[seed]
            print(
                f"    seed {seed}: steps "
                + ", ".join(f"{k} {v:.2f} s" for k, v in run["step_seconds"].items())
                + f"; {run['epochs']} epochs, best val loss {run['best_val_loss']:.6f}; guarded R2 {run['r2']:.6f}, "
                f"MAE {run['mae']:.6f}; per_lab_mean R2 {run['per_lab_mean_r2']:.6f}",
                flush=True,
            )
        # the kernel path in this process: factored heads over a slot-major
        # train batch (K4f / K4b); the aggregations take the dense tier.  At
        # 1,834 patients the flagship's train batch (42,315 rows) lies below
        # SLOT_MAJOR_MIN_ROWS, so with use_pallas: true as written it stays
        # row-major and the heads run as torch layers: the run lowers the
        # threshold to 0 for its masker
        kernel_cfg = flagship_band.seed_config(
            flagship, FLAGSHIP_SEEDS[0], tmp / "kernels",
            model={"use_pallas": True, "extras": {"head_style": "factored"}},
        )
        opts = pipeline.RunOptions(device=dev)
        kernel_seconds = {}
        min_rows = masker_mod.SLOT_MAJOR_MIN_ROWS
        masker_mod.SLOT_MAJOR_MIN_ROWS = 0
        try:
            reset_counts()
            for index in (0, 1, 2, 3, 4, 6):
                name, _, fn, _ = pipeline.STEPS[index]
                step_t = time.perf_counter()
                fn(kernel_cfg, opts)
                torch.cuda.synchronize()
                kernel_seconds[name] = time.perf_counter() - step_t
            pipeline_launches = read_counts(HEAD_PATH_KERNELS)
            # K4f / K4b on the run's own train batch and trained heads
            trainer = pipeline._load_trainer(
                kernel_cfg, pipeline._load_bundle(kernel_cfg, opts), opts, require_checkpoint=True
            )
            head_errs = _trained_head_check(trainer)
            del trainer
        finally:
            masker_mod.SLOT_MAJOR_MIN_ROWS = min_rows
        runs["kernels"] = flagship_band.read_result(tmp / "kernels" / "out")
        print(
            "    seed 42, use_pallas: true, factored heads: steps "
            + ", ".join(f"{k} {v:.2f} s" for k, v in kernel_seconds.items())
            + f"; {runs['kernels']['epochs']} epochs, best val loss {runs['kernels']['best_val_loss']:.6f}; "
            f"guarded R2 {runs['kernels']['r2']:.6f}, MAE {runs['kernels']['mae']:.6f}; "
            f"per_lab_mean R2 {runs['kernels']['per_lab_mean_r2']:.6f}; launch_counts {pipeline_launches}; "
            "K4f / K4b on its train batch and trained heads against the plain versions (max abs err fwd, bwd): "
            + ", ".join(f"{k} {f:.3e}, {b:.3e}" for k, (f, b) in head_errs.items()),
            flush=True,
        )
    for label, run in runs.items():
        if run["missing"]:
            raise AssertionError(f"pipeline run {label}: artifacts missing: {run['missing']}")
        if run["leak"]:
            raise AssertionError(f"pipeline run {label}: the audit reports a leak")
        if not run["r2"] > run["per_lab_mean_r2"]:
            raise AssertionError(
                f"pipeline run {label}: guarded R2 {run['r2']:.6f} does not beat its per_lab_mean "
                f"baseline's {run['per_lab_mean_r2']:.6f}"
            )
    if not (pipeline_launches["pair_head_fwd"] > 0 and pipeline_launches["pair_head_bwd"] > 0):
        raise AssertionError(f"the use_pallas run did not launch K4f and K4b: {pipeline_launches}")
    r2_band = (min(JAX_CPU_BAND["r2"]) - FLAGSHIP_R2_MARGIN, max(JAX_CPU_BAND["r2"]) + FLAGSHIP_R2_MARGIN)
    mae_band = (min(JAX_CPU_BAND["mae"]) - FLAGSHIP_MAE_MARGIN, max(JAX_CPU_BAND["mae"]) + FLAGSHIP_MAE_MARGIN)
    mean_r2 = statistics.fmean(runs[seed]["r2"] for seed in FLAGSHIP_SEEDS)
    mean_mae = statistics.fmean(runs[seed]["mae"] for seed in FLAGSHIP_SEEDS)
    for label, r2, mae in (("3-seed mean", mean_r2, mean_mae), ("use_pallas run", runs["kernels"]["r2"], runs["kernels"]["mae"])):
        if not (r2_band[0] <= r2 <= r2_band[1] and mae_band[0] <= mae <= mae_band[1]):
            raise AssertionError(
                f"{label}: guarded R2 {r2:.6f} / MAE {mae:.6f} outside the band R2 [{r2_band[0]:.4f}, "
                f"{r2_band[1]:.4f}], MAE [{mae_band[0]:.4f}, {mae_band[1]:.4f}] (the JAX package's, CPU)"
            )
    changed = [name for name, state in guarded.items() if _tree_state(repo / name) != state]
    if changed:
        raise AssertionError(f"the pipeline runs wrote into the repo: {changed}")
    torch.cuda.empty_cache()
    _phase(
        "pipeline", t0,
        f"conf/eicu_real.yaml through python -m multi_modal_gnn_tpu_torch.pipeline (steps 1-5, 7), train seeds "
        f"{list(FLAGSHIP_SEEDS)}: guarded R2 mean {mean_r2:.6f} in [{r2_band[0]:.4f}, {r2_band[1]:.4f}], MAE mean "
        f"{mean_mae:.6f} in [{mae_band[0]:.4f}, {mae_band[1]:.4f}]; the use_pallas run launched {pipeline_launches}, "
        f"and K4f / K4b match their plain versions on its train batch and trained heads",
    )

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        if name in attn_results:  # the patient group's times; every timed group under "groups"
            entry.update(
                launches=hgt_train_launches[name],
                launches_per_step=hgt_train_launches[name] // TRAIN_EPOCHS,
                launches_serving=hgt_serving_launches[name],
                **attn_results[name][PATIENT], groups=attn_results[name],
            )
        elif name in probe_results:  # H 64, the script's default; H 128 under "at_h128"
            entry.update(launches=probe_launches[name], **probe_results[name][64], at_h128=probe_results[name][128])
        elif name in dual_errs:
            entry.update(
                launches=dual_launches[name], launches_per_step=dual_launches[name] // TRAIN_EPOCHS,
                **results[name],
            )
        else:
            entry.update(
                launches=train_launches[name], launches_per_step=train_launches[name] // TRAIN_EPOCHS,
                **results[name],
            )
            if name in serving_launches:
                entry["launches_serving"] = serving_launches[name]
        if name in bench_launches:
            entry["launches_bench"] = bench_launches[name]
            entry["launches_lifecycle"] = lifecycle_launches[name]
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
