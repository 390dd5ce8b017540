#!/usr/bin/env python3
"""Smoke run of the PyTorch port's RGCN and HGT serving and training paths,
the RGCN's dual-head training path, the gather probe, the bench, the
trainer's lifecycle (checkpoints, resume, evaluation), the pipeline
command line on the flagship config, the serving artifact, the quality
channels (value context, the bilinear channel, the side-information warm
start), Cluster-GCN mini-batch training, the bfloat16 compute path, the
raw-data ingest path (raw MIMIC-III / eICU CSVs, the host graph core), and
the visualize step with the performance ceilings on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device        the card's name and power limit (nvidia-smi); TF32 off
  2. build         compile csrc/*.cu for sm_90a, one nvcc per source, and
                   the host graph core csrc/graphcore.cpp with g++; the
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
                   at the script's defaults (3840 tiles, 512 rows, H 64) in
                   float32 and with --dtype bfloat16, then A / B / C against
                   their plain versions at H 64 and 128 on float32 and
                   bfloat16 tables: errors, median times, bounds (A's one-hot
                   product's operations beside), library times
 19. bench         python -m multi_modal_gnn_tpu_torch.tools.bench --scale
                   --no-dense --quick through run_bench: its JSON line, a
                   finite positive value, the card named in its device, and
                   K1-K4 launched in its timed chunks; on phase 3's graph
                   (the bench's own, not built again)
 20. lifecycle     on phase 3's graph at full width (dropout 0.2):
                   train_pipeline for 4 epochs (checkpoints every 2) twice,
                   whose relative drift over the losses of epochs 3-4 sets
                   the tolerance (twice it); a fresh trainer's
                   fit(resume_from="auto") from the first run's
                   checkpoint_epoch_2.ckpt to epoch 4, held to that run
                   within it; load_best_model, evaluate_model (baselines
                   global_mean, per_lab_mean; conformal alpha 0.1) and its
                   artifacts; predict_pairs on 4096 test pairs against
                   predict("test") within 1e-5; the run's directory stays
                   for phase 29
 21. pipeline      conf/eicu_real.yaml through python -m
                   multi_modal_gnn_tpu_torch.pipeline (steps 1-8) at
                   train seeds 42-44, side by side on the card (six
                   processes with seed 44's run below, phase 24's
                   warm-start run and phase 27 (f)'s bfloat16 run), held to
                   the JAX package's CPU band;
                   seed 42's serving artifact loaded on the card: its test
                   pairs against the trainer, predict_patient(denormalize=
                   True), intervals (their coverage of the test split
                   printed), cold start with and without an interval
                   against ALSBaseline on the artifact's factors; seed 44
                   once more (steps 1-5) with the CPU's dropout and
                   supervision draws (--draws cpu, tools/cpu_draws.py)
                   beside the card's own
                   and the CPU run's epochs and R2; one use_pallas run
                   (factored heads, steps 1-8 in this process while the
                   command lines run) with K4f / K4b held to their plain
                   versions on its train batch
 22. serving-export export_serving with phase 5's RGCN (K1, K2f, K3 launch in
                   its compute_node_state), phase 12's HGT (K6) and phase
                   5's RGCN in bfloat16 (its bf16 instantiations; its
                   weights.npz size against the float32 one's): file
                   sizes (the programs under 1 % of weights.npz), load with
                   the CUDA graph captures; ServingModel's answers to three
                   500-lab patients, batches of 256 and 4,096 and a
                   10,000-pair request (chunked) (the HGT: the patients)
                   against build_serving_fn within 1e-5 + 1e-5 |ref|, then
                   p50 / p95 of each request type in turns with it, and
                   each bucket's CUDA graph replayed alone (CUDA events); the
                   card's RGCN artifact loaded on the CPU, and a tiny CPU
                   artifact on the card, against the other side
 23. value-context the quality channels on phase 3's graph at full width:
                   (a) the RGCN with model.extras.value_context and the
                   context bilinear source (rank 8), one Adam step with
                   dropout 0 on the card against the CPU plain step (phase
                   8's tolerances), K1-K4 launched; (b) the step's
                   predictions with every supervised train, val and test
                   value perturbed (2 runs; the closest to an unperturbed
                   run) against the drift of four unperturbed runs (the
                   largest), and with the visible train values perturbed
                   (the channel is live); (c) 5 epochs with dropout 0.2 beside
                   phase 9's, a profiled epoch, the context sums timed
                   alone; (d) the head source with dual_head_fusion on:
                   K4, no K5; (e) the HGT with value context and the
                   embedding source (rank 9), flash tier against segment
                   tier, peak memory, K6-K8 launched; (f) the RGCN of (a)
                   in bfloat16: its step against the CPU plain step at
                   phase 27's bounds, bf16 launches per kernel, (b)'s leak
                   check, and the context sums with bf16 against float32
                   patient rows in turns beside torch.sparse.mm on a bf16
                   CSR (its error and time); (g) the HGT of (e) in bfloat16
                   (its value-context projections), flash against segment
                   tier at phase 27's bounds
 24. warm-start    conf/eicu_real.yaml with train.extras.warm_start:
                   sideinfo and its channel written out
                   (flagship_band.warm_start_config) through the command
                   line at train seed 42 (WARM_START_SEEDS; run in phase
                   21's pool), held to the JAX
                   package's CPU band of that file (JAX_CPU_BAND_SIDEINFO); seed 42's plant
                   on the card equals SideInfoALSBaseline on the val pairs
                   within 1e-4, its best val loss is not above the plant's,
                   and its step-8 artifact carries bl_u / bl_l and answers
                   like the trainer
 25. clusters      Cluster-GCN on phase 3's graph: (a) the K = 8
                   edge-balanced partition (bases, local_size, each
                   relation's padded edges and tier, build seconds), every
                   valid edge in exactly one cluster (host check); (b) one
                   cluster step (base > 0, dropout 0, the embedding bilinear
                   source at rank 8) on the card against the CPU plain step
                   (phase 8's tolerances), embed_patient's gradient only on
                   the cluster's window, K1 / K2f / K2b launched and K3 not;
                   (c) K1, K2f and K2b at the cluster shapes of K = 8 and of
                   K = 64 equal-patient ranges (fused patient tables), and K1
                   as a cluster batch's gather backward, against their plain
                   versions (phase 4's tolerances), timed beside their bounds
                   and torch.sparse.mm (index_add_ for the gather); (d) K = 1
                   against full batch (mask fraction 0, dropout 0, 3 epochs)
                   on a window-aligned scale_100k cohort (99,968 patients):
                   first loss rtol 1e-5, third loss and validation loss
                   rtol 1e-4 / atol 1e-5 (JAX's bound), test predictions
                   within twice the drift of four full-batch runs (the
                   count over JAX's elementwise bound printed);
                   (e) full batch, device-resident and host-resident K = 8, 3
                   epochs each, 6 device- and 2 host-resident runs in turns
                   from one init: each run's drift from the first printed,
                   every host-resident run within twice the largest drift
                   between device-resident runs, peak memory (host-resident below
                   device-resident by K - 3 clusters' edge sets), epoch ms,
                   launches of a cluster epoch, a profiled host-resident
                   epoch's share of copy time overlapping kernels; (f) the
                   HGT, K = 16, host-resident, 2 epochs: tiers, peak, epoch
                   ms, the validation loss below the untrained one; (g)
                   run_bench(scale, no dense, quick, clusters=8, bf16)'s
                   line; (b) also in bfloat16 (phase 27's bounds; K1 / K2f
                   bf16, K2b float32); (h) bfloat16 at K = 8: K1 / K2f / K2b
                   at the cluster sites against their plain versions, timed
                   in turns with their float32 launches, and 6 device- and
                   2 host-resident runs under (e)'s check
 26. cluster-quality JAX tests/test_minibatch.py's K > 1 quality pin with the
                   port on the card (eicu_demo, signal 0.6, side-info warm
                   start, 60 epochs): R2 of K = 1 and K = 4 both >= 0.22,
                   within 0.005 of each other, and K = 4 within 0.02 of the
                   JAX CPU value (JAX_CPU_R2_K4); K = 4 once more in
                   bfloat16: R2 >= 0.22 and within 0.03 of float32's
 27. bf16          model.compute_dtype bfloat16 | auto on phase 3's graph:
                   (a) the tensor-core probe (utils/mxu_probe.py, called
                   directly: its t_f32 / t_bf16 lists and ratios) and
                   build_model with auto against the rule; (d) the bf16
                   node state and three request types against the CPU
                   plain versions, as a share of bf16's own effect (the
                   same weights in f32); (c) one bf16 train step (dropout
                   0) against the CPU plain step (loss to one rounding,
                   gradients per tensor, parameters after Adam), K1 / K2f /
                   K3 / K4f / K4b launching their bf16 instantiations, and
                   the step with dual_head_fusion on (K5f / K5b bf16)
                   against off; (b) every bf16 kernel of the path against
                   its plain version at the path's shapes (K1 at each call
                   site of the step, K2f and K2b on the three fused-table
                   relations, K3, K4f / K4b on the span@256 batch, K5f /
                   K5b on the full-table batch; a planted 601-fold edge for
                   K2b and K3), timed in turns with its f32 kernel beside
                   its bound for 2-byte rows; their -Xptxas -v lines; (e)
                   5 RGCN and 2 HGT epochs each in bf16 and f32 in turns
                   (epoch ms, device ms and idle share, peak memory) and
                   bench --scale --no-dense --quick --bf16's line; (f) JAX's
                   bf16 quality pin with the port (R2 >= 0.15; f32 beside
                   it) and conf/eicu_real.yaml in bf16 at seed 42 within
                   0.03 of phase 21's float32 run of that seed (the JAX
                   package's bf16 run beside it), through the command line
                   (steps 1-8, run in phase 21's pool), its bf16 artifact
                   served on the card as phase 21 serves seed 42's
 28. ingest        tools/bench_etl's raw MIMIC-III-shaped CSVs (46,000
                   patients, 5,000,000 LABEVENTS rows, 720 labs, seed 0):
                   (a) written; (b) the graph core's LABEVENTS scan against
                   its plain version (run once, on the .csv) on the first
                   250,000 rows as .csv and .csv.gz (bit-equal arrays),
                   then the full cohort scan (rows/s); (c)
                   preprocess_pipeline (top 500 labs) and the graph build
                   with the core, then with the plain numpy plans, every
                   plan array equal;
                   (d) 3 full-batch RGCN epochs at the default widths with
                   use_pallas and no dense tier: the kernels of the tiers
                   and the fused pair heads launched, finite losses,
                   evaluate_model's finite test metrics; (e) a raw eICU
                   directory through python -m multi_modal_gnn_tpu_torch
                   --step 1-4 on the card
 29. visualize     the pipeline's step 6 (viz.visualize) and the ceilings:
                   (a) on phase 20's run directory (scale_100k, full width,
                   use_pallas, dense budget 0), the trainer restored from
                   its best checkpoint: K1, K2f and K3 launched, seconds,
                   the figures left out and why (matplotlib absent: every
                   figure; present: every PNG written), per_lab_calibration.csv
                   against the same function on the CPU plain path's test
                   predictions and the embeddings' PCA plane against the
                   CPU's (VIZ_ATOL); (b) the same step on phase 14's HGT on
                   its flash tier (K6 launched) against the segment tier on
                   the card; (c) the flat Bayes ceiling of phase 3's cohort
                   on its train / test split, card against CPU within 1e-9
                   relative (seconds, peak memory), and the LMMSE ceiling
                   of conf/eicu_real.yaml's cohort against the JAX
                   package's CPU value (JAX_CPU_LMMSE) beside phase 21's
                   band; (d) python -m
                   multi_modal_gnn_tpu_torch.tools.diagnose_quality --spec
                   eicu --epochs 30 on the card, its yardsticks against its
                   --device cpu --skip-train run's within 1e-9 (both started
                   at the phase's start, in the background of (a)-(c))
Then a JSON line of per-kernel results (a kernel with a bf16 instantiation
also carries launches_bf16_step and its bf16 results, and its bf16 cluster
sites and value-context launches; P1's bf16 kernels have rows of their
own; every row carries launches_visualize, its launches in phase 29's
step 6), the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the last line; without a CUDA device it fails in phase 1.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
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
# phase 24: the same flagship with train.extras.warm_start: sideinfo and its
# channel written out (tools/flagship_band.warm_start_config), held to the
# JAX package's band of that derived file with phase 21's margins: `python
# scripts/flagship_band_jax.py --config <derived file>` on the CPU, seeds
# 42, 43, 44 in order
# phase 21: float32 seed 44 with the CPU's random draws on the card, beside
# the port's CPU run of that seed (tools/flagship_band.py --seeds 44 --device
# cpu, and the same with --draws cpu: the same 100 epochs and R2)
STREAM_SEED = 44
CPU_SEED44 = {"epochs": 100, "r2": 0.3044513639624198}
JAX_CPU_BAND_SIDEINFO = {
    "r2": (0.27537223719962145, 0.2878246991449701, 0.2853947600452612),
    "mae": (0.5681749143247993, 0.5810189486826384, 0.5760004550891525),
}
# phase 24 trains seed 42 alone (phase 21 keeps all three): its depth was cut
# to hold all 27 phases near 900 s, the band check is unchanged
WARM_START_SEEDS = FLAGSHIP_SEEDS[:1]
# phase 24: the val predictions right after the plant against the baseline
# (float64 numpy) on the card
WARM_START_ATOL = 1e-4
# phase 23: the bilinear ranks of the RGCN (context and head sources) and of
# the HGT (embedding source)
VC_RANK, VC_HGT_RANK = 8, 9
# phase 23 (f): bf16 predictions drift between runs by a bf16 rounding that
# goes the other way (float32: by float32 sums in another order), so the
# visible values must move them by 10 times the drift (float32: 1e3 times)
VC_LIVE_FACTOR_BF16 = 10
# phases 21-22: served answers against the eager serving path and the
# trainer, both on the card (f32 sums of the state's atomics in another order)
SERVE_ATOL, SERVE_RTOL = 1e-5, 1e-5
# phase 22: the request types, and pairs past the largest bucket (chunked)
SERVE_PATIENTS = 3
SERVE_BATCHES = (256, 4096)
SERVE_CHUNKED = 10_000
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
    # P1 on bfloat16 tables (the script's --dtype bfloat16)
    "gather_probe_indicator_bf16": (PROBE_SOURCE, "scripts/bench_gather_impl.py:57"),
    "gather_probe_padded_bf16": (PROBE_SOURCE, "scripts/bench_gather_impl.py:57"),
    "gather_probe_direct_bf16": (PROBE_SOURCE, "scripts/bench_gather_impl.py:57"),
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


# phase 27 (bfloat16): rows, node projections and W1 in bfloat16, sums in
# float32.  A bfloat16 value has 8 significant bits: one spacing is at most
# 2^-7 of it.  The loss of a step whose heads take bfloat16 inputs: within
# one rounding, 2^-8.  A gradient that leaves in bfloat16 is rounded from a
# float32 sum in another order on each side, and a slot gradient summed into
# it may round the other way: within 1e-4 of its largest element except for
# at most BF16_FLIP_SHARE of its elements, each within one spacing of the
# largest.  The bounds of 2-byte rows use the bfloat16 tensor-core peak for
# operations (NVIDIA's data sheet, dense)
BF16_ULP = 2.0 ** -7
BF16_LOSS_RTOL = 2.0 ** -8
BF16_FLIP_SHARE = 1e-3
BF16_FLOPS = 989e12
# phase 27 (c): a bfloat16 step's gradients against another bfloat16 step's
# (card against CPU plain; dual on against off), per tensor in the 2-norm.
# The two sides round activations to bfloat16 after float32 sums in other
# orders, so a unit within a bfloat16 rounding of its ReLU's kink takes the
# other branch (65,536 times as many units as within float32's rounding),
# and BatchNorm's backward over the 500 labs subtracts means that nearly
# cancel: the card against the CPU plain step drifted up to 0.205 of a
# gradient's norm (conv_0.neigh_patient__has_lab__lab.weight; 0.098 for
# embed_patient, phase 8's float32 drift there 1e-2), every head gradient
# below 3e-3 (NVIDIA H100 80GB HBM3, 700.00 W).  Held to three times the
# largest drift; a fault of the path (a relation's gradient dropped,
# misscaled or sent through the wrong plan) moves whole terms of a tensor
BF16_STEP_GRAD_NORM_REL = 0.6
# phase 27 (d): the node state and answers, card against CPU plain, as a
# share of bfloat16's own effect on them (the same weights in float32)
BF16_STATE_RATIO = 0.5
# (f) JAX tests/test_mxu_probe.py's quality pin (R2 >= 0.15 under bfloat16),
# and its "dtype noise budget" (0.03) for the flagship in bfloat16 at train
# seed 42 against phase 21's float32 run of that seed.  The JAX package's
# bfloat16 run of it on the CPU is printed beside them, not held to: `python
# scripts/flagship_band_jax.py --config <the flagship with
# model.compute_dtype: bfloat16, tools/flagship_band.dtype_config> --seeds
# 42`.  Its scatter-adds round at every add, so the pair head's lab
# gradients (40,000 rows summed into 50) carry a few percent of error and
# its run stalls and stops at 30 epochs, 0.039 below its float32 seed 42;
# the port sums bfloat16 rows in float32 (ops/segment.py)
BF16_PIN_R2_MIN = 0.15
BF16_NOISE_BUDGET = 0.03
JAX_CPU_BF16_R2_42 = 0.23711894617133844
BF16_RGCN_EPOCHS, BF16_HGT_EPOCHS = 5, 2
# phase 28 (ingest): tools/bench_etl's raw MIMIC-III-shaped directory at the
# mimic_scale cohort (scripts/bench_etl.py's defaults), its top 500 labs,
# the scan's native route against its plain version on the first
# ETL_SCAN_ROWS rows, RGCN epochs at the default widths on the kernel path
ETL_PATIENTS, ETL_LAB_ROWS, ETL_LABS, ETL_DX, ETL_RX = 46_000, 5_000_000, 720, 800, 400
ETL_SCAN_ROWS = 250_000
ETL_EPOCHS = 3
ETL_EICU_STAYS = 3_000
# phase 29: the visualize step and the ceilings.  The calibration table and
# the PCA plane of step 6 on the card against the same functions on the CPU
# plain path's predictions and embeddings: f32 sums in another order move the
# predictions by ~1e-5, and a recalibrated MAE divides them by the lab's
# slope, so those two columns are held to 1e-4 (1 + |ref|) / min(1, |slope|)
VIZ_ATOL = 1e-4
# the Bayes and LMMSE ceilings in float64: the card's sums against the
# CPU's, and the JAX package's LMMSE ceiling of conf/eicu_real.yaml's cohort
# (SyntheticSpec.eicu_real(0), default splits at seed 42), as
# `python tests/jax_lmmse_ceiling.py` prints it on the CPU
CEILING_REL = 1e-9
JAX_CPU_LMMSE = {
    "mae": 0.5676102175632975, "rmse": 0.9063563055042431, "r2": 0.11039252727203197,
    "mape": 108.88189645568704,
}
# (d): tools/diagnose_quality on the card, beside its CPU yardsticks
DIAGNOSE_EPOCHS = 30
# the bfloat16 instantiations' -Xptxas -v lines, by kernel
BF16_NAMED = tuple((label, entry + "13__nv_bfloat16") for label, entry in (
    ("K2b", "incidence_kernelILb0E"), ("K3", "incidence_kernelILb1E"),
    ("K2f / K1 small table", "gather_runs_kernelI"), ("K1 large table", "gather_tile_kernelILb0E"),
    ("K1 pre-gathered", "gather_tile_kernelILb1E"), ("K4f", "pair_head_fwd_kernelI"),
    ("K4b", "pair_head_bwd_kernelI"), ("K5f", "pair_head_dual_fwd_kernelI"), ("K5b", "pair_head_dual_bwd_kernelI"),
))


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


def _cut_run_plan(tiles: int, seed: int):
    """A windowed plan (``local``, ``tile_map``, ``num_windows``) whose tiles
    hold unsorted runs over six rows of their window, as a span-mode train
    batch does (each window's slots ordered by lab, so a patient's runs are
    cut at chunk boundaries that other runs of it follow): runs of 1-8 or
    1-149 slots, padding at each tile's end, four tiles a window."""
    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW

    rng = np.random.default_rng(seed)
    local = np.full((tiles, TILE_E), WINDOW, np.int32)
    for t in range(tiles):
        vals = []
        while len(vals) < TILE_E:
            vals += [int(rng.integers(0, 6))] * int(rng.integers(1, 9) if rng.random() < 0.5 else rng.integers(1, 150))
        real = TILE_E - int(rng.integers(0, 100))
        local[t, :real] = vals[:real]
    tile_map = np.arange(tiles, dtype=np.int32) // 4
    return torch.from_numpy(local.reshape(-1)), torch.from_numpy(tile_map), -(-tiles // 4)


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


def _served_vs_eager(served, fn, requests, num_l, label: str) -> dict:
    """Hold the artifact's answers to each request against the eager
    serving path's, then time both in turns (eager, artifact, artifact,
    eager; ``TIMING_REPS`` requests each, host clock, each ending in its
    readback).  ``{request type: {p50 / p95 of each}}``."""
    import numpy as np
    import torch

    def artifact(req):
        kind, arg = req
        return served.predict(np.full(num_l, arg), np.arange(num_l)) if kind == "patient" else served.predict(*arg)

    def eager(req):
        kind, arg = req
        return (fn(np.full(num_l, arg), np.arange(num_l)) if kind == "patient" else fn(*arg)).cpu()

    for req in requests:
        got = artifact(req)
        _compare(f"{label} artifact, {req[0]} request ({got.shape[0]} pairs)", torch.from_numpy(got), eager(req),
                 SERVE_ATOL, SERVE_RTOL)
    times = {}
    for req in requests:
        kind = req[0] if req[0] == "patient" else f"pairs {req[1][0].shape[0]}"
        if kind in times:
            continue
        lat = {"eager": [], "artifact": []}
        for who in ("eager", "artifact", "artifact", "eager"):
            call = eager if who == "eager" else artifact
            call(req)
            for _ in range(TIMING_REPS):
                t = time.perf_counter()
                call(req)
                lat[who].append((time.perf_counter() - t) * 1e3)
        times[kind] = {
            f"{who}_{q}_ms": float(np.percentile(v, pct)) for who, v in lat.items() for q, pct in (("p50", 50), ("p95", 95))
        }
        print(
            f"    {label} {kind}: artifact p50 {times[kind]['artifact_p50_ms']:.4f} ms, p95 "
            f"{times[kind]['artifact_p95_ms']:.4f} ms; eager build_serving_fn p50 {times[kind]['eager_p50_ms']:.4f} ms, "
            f"p95 {times[kind]['eager_p95_ms']:.4f} ms (host clock, readback included, {2 * TIMING_REPS} each, in turns)",
            flush=True,
        )
    return times


def _flagship_serving_check(run_dir: Path, dev) -> str:
    """Phase 21: the flagship run's step-8 artifact on the card against its
    trainer (test pairs), its denormalized patient report, its intervals'
    empirical coverage on the test split and its cold start against the
    port's ALSBaseline on the artifact's factors."""
    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch import pipeline
    from multi_modal_gnn_tpu_torch.config import load_config
    from multi_modal_gnn_tpu_torch.evaluation import ALSBaseline
    from multi_modal_gnn_tpu_torch.serving import ServingModel

    cfg = load_config(run_dir / "config.yaml")
    opts = pipeline.RunOptions(device=dev)
    trainer = pipeline._load_trainer(cfg, pipeline._load_bundle(cfg, opts), opts, require_checkpoint=True)
    path = Path(cfg.data.output_dir) / "serving"
    t = time.perf_counter()
    served = ServingModel.load(path, device=dev)
    load_s = time.perf_counter() - t
    test_p, test_l, test_v = trainer.masker.split_arrays("test")
    want = trainer.predict_pairs(test_p, test_l)
    err, _ = _compare(f"flagship artifact on {len(test_p)} test pairs against the trainer",
                      torch.from_numpy(served.predict(test_p, test_l)), torch.from_numpy(want), SERVE_ATOL, SERVE_RTOL)
    num_l = served.manifest["num_labs"]
    patient = int(test_p[0])
    report = served.predict_patient(patient, denormalize=True)
    raw = served.predict(np.full(num_l, patient), np.arange(num_l))
    stats = served.manifest["lab_stats"]
    mean = np.asarray([stats[str(i)]["mean"] if str(i) in stats else 0.0 for i in range(num_l)])
    std = np.asarray([stats[str(i)]["std"] if str(i) in stats else 1.0 for i in range(num_l)])
    _compare(f"flagship predict_patient({patient}, denormalize=True) against z * std + mean",
             torch.tensor(list(report.values()), dtype=torch.float64), torch.from_numpy(raw * std + mean), 1e-9, 1e-9)
    preds, lo, hi = served.predict(test_p, test_l, return_interval=True)
    if not (np.all(lo <= preds) and np.all(preds <= hi) and np.all(np.isfinite(hi - lo))):
        raise AssertionError("flagship intervals do not hold their point predictions")
    coverage = float(np.mean((test_v >= lo) & (test_v <= hi)))
    alpha = served._conformal.alpha
    tr_p, tr_l, tr_v = trainer.masker.split_arrays("train")
    observed = {int(lab): float(v) for lab, v in zip(tr_l[tr_p == patient], tr_v[tr_p == patient])}
    with np.load(path / "coldstart.npz") as z:
        als = ALSBaseline(1, num_l, rank=z["C"].shape[1], reg=float(z["reg"]))
        als.C, als.lab_bias = z["C"], z["lab_bias"]
    obs_l = np.asarray(sorted(observed))
    want_cold = als.predict_cold_start(obs_l, np.asarray([observed[i] for i in obs_l]), np.arange(num_l))
    cold = served.predict_cold_start(observed)
    cold_iv = served.predict_cold_start(observed, return_interval=True)
    _compare(f"flagship predict_cold_start ({len(observed)} observed labs) against ALSBaseline",
             torch.tensor(list(cold.values()), dtype=torch.float64), torch.from_numpy(want_cold), 1e-12, 0.0)
    _compare("flagship predict_cold_start(return_interval=True) predictions",
             torch.tensor([v["predicted"] for v in cold_iv.values()], dtype=torch.float64),
             torch.from_numpy(want_cold), 1e-12, 0.0)
    if not all(v["interval"][0] <= v["predicted"] <= v["interval"][1] for v in cold_iv.values()):
        raise AssertionError("flagship cold-start intervals do not hold their predictions")
    sizes = {f.name: f.stat().st_size for f in sorted(path.iterdir())}
    return (
        f"seed 42's artifact ({sizes}) loaded on {dev} in {load_s:.3f} s: test pairs within {err:.2e} of the "
        f"trainer; intervals at alpha {alpha} cover {coverage:.4f} of {len(test_v)} test values (target "
        f"{1 - alpha:.2f}); cold start from {len(observed)} labs equals ALSBaseline on the artifact's factors"
    )


# phase 25: Cluster-GCN mini-batch training on phase 3's graph.  K = 8
# edge-balanced (JAX's default balance) for the partition, the step, the
# resident modes and the bench; K = 64 equal-patient ranges for the kernels at
# fused-table patient tables (1,664 rows); K = 16 for the HGT
CLUSTER_K, CLUSTER_K_SMALL, CLUSTER_K_HGT = 8, 64, 16
CLUSTER_EPOCHS, CLUSTER_HGT_EPOCHS = 3, 2
# (e): device- and host-resident runs from one init, in turns; (h) the same
# in bfloat16, whose runs drift further apart (a bf16 rounding that goes the
# other way): three device-resident runs gave a spread of 1.2e-04 in one
# call and 1.9e-04 in another, so its sample is as large as (e)'s
CLUSTER_DEVICE_RUNS, CLUSTER_HOST_RUNS = 6, 2
CLUSTER_DEVICE_RUNS_BF16, CLUSTER_HOST_RUNS_BF16 = 6, 2
CLUSTER_RANK = 8  # the embedding bilinear source of the step check
# (d): K = 1 against full batch after 3 epochs, JAX's own bound for this
# comparison (tests/test_minibatch.py:100-103) on the third loss and the
# validation loss; the first epoch's loss at the step's rtol.  The test
# predictions are held to twice the drift of four full-batch runs from the
# same weights (the largest |difference| of their six pairs; three runs'
# pairs gave 2.244e-05 and 2.129e-05 on the H100), as phase 20 holds a
# resume, and the count over JAX's elementwise bound is printed: a
# cluster rebuilds its reverse relations from the destination-sorted forward
# edges, so each patient's lab / diagnosis / medication -> patient sums run
# in another order than the full graph's (JAX's partition does the same),
# and three Adam steps carry that rounding into the predictions: a largest
# |difference| of 1.787e-05 to 3.399e-05 in four runs on the H100 at
# scale_100k (predictions up to 0.103), over the elementwise 1e-5 + 1e-4
# |ref| (7.3e-06 in one CPU thread at 2,560 patients), which JAX's test meets
# at 128 patients.  A cluster's patient table is padded to whole 128-row
# windows and the padding rows enter the BatchNorm statistics, so K = 1
# equals full batch only on a window-aligned cohort (as JAX's test uses):
# scale_100k cut to 781 windows of patients
K1_RTOL, K1_ATOL = 1e-4, 1e-5
K1_FULL_RUNS = 4
K1_PATIENTS = 781 * 128
# the full-batch HGT segment tier's peak on the H100 (PERF.md section 6)
HGT_SEGMENT_PEAK_GIB = 60.94
# phase 26: JAX tests/test_minibatch.py:375-455 on the card: both R2 >= 0.22,
# |R2(K=4) - R2(K=1)| <= 0.005, and the port's K = 4 R2 within 0.02 of the JAX
# package's K = 4 R2 for the same recipe on the CPU: that test's run(4), as
# `python tests/jax_minibatch_quality.py` prints it, measured on 2026-10-18
# (its run(1): 0.23848633617816206)
QUALITY_EPOCHS = 60
QUALITY_R2_MIN, QUALITY_R2_GAP, QUALITY_JAX_MARGIN = 0.22, 0.005, 0.02
JAX_CPU_R2_K4 = 0.23874707503417192


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _copy_overlap(prof) -> tuple:
    """(the share of host-to-device copy time that overlaps kernels, copy ms,
    copies, kernel busy ms, the trace's device span ms) in a torch.profiler
    trace."""
    from torch.autograd import DeviceType

    host_names = {evt.name for evt in prof.events() if evt.device_type == DeviceType.CPU}
    copies, kernels = [], []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or evt.name in host_names:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        if "HtoD" in evt.name:
            copies.append(span)
        elif not evt.name.startswith(("Memcpy", "Memset")):
            kernels.append(span)
    busy = _merge(kernels)
    total = sum(hi - lo for lo, hi in copies)
    covered = 0.0
    for lo, hi in copies:
        for blo, bhi in busy:
            if bhi <= lo:
                continue
            if blo >= hi:
                break
            covered += min(hi, bhi) - max(lo, blo)
    spans = copies + kernels
    span = (max(hi for _, hi in spans) - min(lo for lo, _ in spans)) if spans else 0.0
    busy_us = sum(hi - lo for lo, hi in busy)
    return (covered / total if total else float("nan")), total / 1e3, len(copies), busy_us / 1e3, span / 1e3


def _cluster_kernels(cd, label, dev, d) -> dict:
    """K1, K2f and K2b at a partition's cluster shapes (its cluster with the
    most patient -> lab edges) against their plain versions, each timed
    with its plain version, its bound and torch.sparse.mm."""
    import torch

    from multi_modal_gnn_tpu_torch.graph.hetero import WINDOW
    from multi_modal_gnn_tpu_torch.graph.schema import PATIENT_LAB, mirror_edge_type
    from multi_modal_gnn_tpu_torch.ops import aggregation_tier
    from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk

    k = max(range(len(cd.subgraphs)), key=lambda i: cd.subgraphs[i].edges[PATIENT_LAB].num_valid)
    g = cd.subgraphs[k].to(dev)
    gen = torch.Generator().manual_seed(25)
    sites = {}

    def record(name, rel, kernel, plain, library, got, want, nbytes, flops):
        max_abs, _ = _compare(f"{label} {name} on {rel}", got, want, KERNEL_ATOL, KERNEL_RTOL)
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        lib_ms = _library_ms(f"{label} {name} on {rel}", library)
        bound = _bound(nbytes, flops)
        print(
            f"    {label} {name} on {rel}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms  bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})",
            flush=True,
        )
        sites.setdefault(name, {})[rel] = {
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": lib_ms,
        }

    for et, es in g.edges.items():
        rel = "/".join(et)
        mirror = g.edges[mirror_edge_type(et)]
        tier = aggregation_tier(es, mirror, d)
        print(f"    {label}, cluster {k}: {rel}: tier {tier}  E {es.num_valid} (padded {es.src.shape[0]})  "
              f"sources {es.num_src}  windows {es.num_windows}")
        x = torch.randn(es.num_src, d, generator=gen).to(dev)
        csr = _csr(es.row_ptr, es.src, es.num_dst, es.num_src, dev)
        cnt = es.dst_count.clamp_min(1.0)[:, None]
        plan = (es.win_src, es.win_local, es.win_tile_map)
        out_bytes = es.num_windows * WINDOW * d * 4
        if tier == "paired":
            kernel = lambda x=x, es=es: sk.segment_sum_windowed(x, *plan_of(es), es.num_windows)  # noqa: E731
            plain = lambda x=x, es=es: sk.segment_sum_windowed_plain(x, *plan_of(es), es.num_windows)  # noqa: E731
            record("segment_sum_windowed", rel, kernel, plain, lambda csr=csr, x=x: torch.sparse.mm(csr, x),
                   kernel()[: es.num_dst] / cnt, plain()[: es.num_dst] / cnt,
                   _nbytes(x, *plan) + out_bytes, es.num_valid * d)
        elif tier == "fused_table":
            kernel = lambda x=x, es=es: sk.fused_table_segment_sum(x, *plan_of(es), es.num_windows)  # noqa: E731
            plain = lambda x=x, es=es: sk.fused_table_segment_sum_plain(x, *plan_of(es), es.num_windows)  # noqa: E731
            record("fused_table_segment_sum", rel, kernel, plain, lambda csr=csr, x=x: torch.sparse.mm(csr, x),
                   kernel()[: es.num_dst] / cnt, plain()[: es.num_dst] / cnt,
                   _nbytes(x, *plan) + out_bytes, es.num_valid * d)
            gd = torch.randn(es.num_dst, d, generator=gen).to(dev)
            per_src = torch.bincount(es.win_src[es.win_local < WINDOW].long(), minlength=es.num_src)
            per_src = per_src.clamp_min(1).double()[:, None]
            bwd = lambda gd=gd, es=es: sk.fused_table_segment_sum_bwd(gd, *plan_of(es), es.num_src)  # noqa: E731
            bwd_plain = lambda gd=gd, es=es: sk.fused_table_segment_sum_bwd_plain(gd, *plan_of(es), es.num_src)  # noqa: E731
            csr_t = _csr(mirror.row_ptr, mirror.src, mirror.num_dst, mirror.num_src, dev)
            record("fused_table_segment_sum_bwd", rel, bwd, bwd_plain,
                   lambda csr_t=csr_t, gd=gd: torch.sparse.mm(csr_t, gd),
                   bwd() / per_src, bwd_plain() / per_src,
                   _nbytes(gd, *plan) + es.num_src * d * 4, es.num_valid * d)
        else:
            raise AssertionError(f"{label}: {rel} takes tier {tier}, not paired or fused_table")
    return sites


def _cluster_kernels_bf16(cd, label, dev, d) -> dict:
    """K1 and K2f in their bfloat16 instantiations and K2b at a partition's
    cluster shapes (its cluster with the most patient -> lab edges) against
    their plain versions on bfloat16 rows (as means), each timed in turns
    with its float32 launch (bf16, f32, f32, bf16) beside its bound for
    2-byte rows.  A bf16 step launches K2b in float32 (JAX hands the
    fused-table backward float32); its bf16 instantiation is timed too."""
    import torch

    from multi_modal_gnn_tpu_torch.graph.hetero import WINDOW
    from multi_modal_gnn_tpu_torch.graph.schema import PATIENT_LAB, mirror_edge_type
    from multi_modal_gnn_tpu_torch.ops import aggregation_tier
    from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk

    k = max(range(len(cd.subgraphs)), key=lambda i: cd.subgraphs[i].edges[PATIENT_LAB].num_valid)
    g = cd.subgraphs[k].to(dev)
    gen = torch.Generator().manual_seed(28)
    sites = {}

    def site(name, rel, kernel, plain, rows, out_rows, per, es):
        x = torch.randn(rows, d, generator=gen).to(dev)
        xb = x.to(torch.bfloat16)
        max_abs, _ = _compare(f"{label} bf16 {name} on {rel}", kernel(xb) / per, plain(xb) / per,
                              KERNEL_ATOL, KERNEL_RTOL)
        t = [_median_ms(lambda: kernel(xb)), _median_ms(lambda: kernel(x)), _median_ms(lambda: kernel(x)),
             _median_ms(lambda: kernel(xb))]
        bound = _bound(_nbytes(xb, es.win_src, es.win_local, es.win_tile_map) + out_rows * d * 4, es.num_valid * d)
        entry = {"max_abs_err": max_abs, "ms": (t[0] + t[3]) / 2, "f32_ms": (t[1] + t[2]) / 2, "turns_ms": t,
                 "plain_ms": _median_ms(lambda: plain(xb), 5), **bound}
        print(f"    {label} bf16 {name} on {rel}: turns bf16, f32, f32, bf16 {', '.join('%.4f' % v for v in t)} ms; "
              f"plain {entry['plain_ms']:.4f} ms; bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, 2-byte rows)",
              flush=True)
        sites.setdefault(name, {})[rel] = entry

    for et, es in g.edges.items():
        rel = "/".join(et)
        tier = aggregation_tier(es, g.edges[mirror_edge_type(et)], d)
        plan = (es.win_src, es.win_local, es.win_tile_map)
        cnt = es.dst_count.clamp_min(1.0)[:, None]
        out_rows = es.num_windows * WINDOW
        if tier == "paired":
            site("segment_sum_windowed", rel, lambda x, es=es, plan=plan: sk.segment_sum_windowed(
                x, *plan, es.num_windows)[: es.num_dst], lambda x, es=es, plan=plan: sk.segment_sum_windowed_plain(
                x, *plan, es.num_windows)[: es.num_dst], es.num_src, out_rows, cnt, es)
        elif tier == "fused_table":
            site("fused_table_segment_sum", rel, lambda x, es=es, plan=plan: sk.fused_table_segment_sum(
                x, *plan, es.num_windows)[: es.num_dst], lambda x, es=es, plan=plan: sk.fused_table_segment_sum_plain(
                x, *plan, es.num_windows)[: es.num_dst], es.num_src, out_rows, cnt, es)
            per_src = torch.bincount(es.win_src[es.win_local < WINDOW].long(), minlength=es.num_src)
            site("fused_table_segment_sum_bwd", rel, lambda x, es=es, plan=plan: sk.fused_table_segment_sum_bwd(
                x, *plan, es.num_src), lambda x, es=es, plan=plan: sk.fused_table_segment_sum_bwd_plain(
                x, *plan, es.num_src), es.num_dst, es.num_src, per_src.clamp_min(1).double()[:, None], es)
        else:
            raise AssertionError(f"{label}: {rel} takes tier {tier}, not paired or fused_table")
    return sites


def plan_of(es):
    """An edge set's windowed plan: (win_src, win_local, win_tile_map)."""
    return es.win_src, es.win_local, es.win_tile_map


def _clusters_phase(dev, graph_cpu, graph, graph_hgt, config, masker, reset_counts, counts_of) -> dict:
    """Phase 25.  Returns the per-kernel additions to the kernels line."""
    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
    from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta, host_edges_of
    from multi_modal_gnn_tpu_torch.graph.hetero import WINDOW
    from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB, mirror_edge_type
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.models.losses import compute_lab_weights
    from multi_modal_gnn_tpu_torch.ops import aggregation_tier
    from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
    from multi_modal_gnn_tpu_torch.tools import bench
    from multi_modal_gnn_tpu_torch.training import MiniBatchTrainer, Trainer, masker_from_config
    from multi_modal_gnn_tpu_torch.training.minibatch import build_patient_clusters

    d = config.model.hidden_dim
    out = {}
    laps = [time.perf_counter()]

    def lap(label):
        laps.append(time.perf_counter())
        print(f"    ({label}) {laps[-1] - laps[-2]:.1f} s", flush=True)
    bundle = GraphBundle(graph=graph_cpu, meta=GraphMeta(), host_edges=host_edges_of(graph_cpu))
    _, tr_l, tr_v = masker.split_arrays("train")
    lab_w = compute_lab_weights(tr_v, tr_l, graph_cpu.num_nodes(LAB))

    # (a) the partition
    t_build = time.perf_counter()
    cd = build_patient_clusters(bundle, masker, config, CLUSTER_K, lab_weights=lab_w)
    build_s = time.perf_counter() - t_build
    g0 = cd.subgraphs[0]
    print(f"    (a) K {CLUSTER_K} edges: built in {build_s:.2f} s; bases {cd.bases}; local_size {cd.local_size}")
    for et, es in g0.edges.items():
        tier = aggregation_tier(es, g0.edges.get(mirror_edge_type(et)), d)
        print(f"      {'/'.join(et)}: padded edges {es.src.shape[0]} a cluster  windows {es.num_windows}  tier {tier}  "
              f"valid per cluster {[g.edges[et].num_valid for g in cd.subgraphs]}")
    num_p = graph_cpu.num_nodes(PATIENT)
    ends = cd.bases[1:] + [num_p]
    for et, (src, dst, val) in bundle.host_edges.items():
        if et[0] != PATIENT:
            continue
        num_dst = graph_cpu.num_nodes(et[2])
        keys, vals = [], []
        for k, g in enumerate(cd.subgraphs):
            es = g.edges[et]
            n = es.num_valid
            s_loc = es.src[:n].numpy().astype(np.int64)
            if n and (s_loc.min() < 0 or s_loc.max() >= ends[k] - cd.bases[k]):
                raise AssertionError(f"cluster {k} of {et}: a source outside its patient range")
            keys.append((s_loc + cd.bases[k]) * num_dst + es.dst[:n].numpy())
            if val is not None:
                vals.append(es.val[:n].numpy())
        got = np.concatenate(keys)
        want = np.asarray(src, np.int64) * num_dst + np.asarray(dst)
        if val is not None:
            o_got, o_want = np.lexsort((np.concatenate(vals), got)), np.lexsort((val, want))
            same = np.array_equal(got[o_got], want[o_want]) and np.array_equal(np.concatenate(vals)[o_got], val[o_want])
        else:
            same = np.array_equal(np.sort(got), np.sort(want))
        if not same:
            raise AssertionError(f"{et}: the clusters' edges are not the graph's, each once")
    print(f"    (a) every valid edge of the three forward relations lies in exactly one cluster (host check)")
    cluster_bytes = _nbytes(*g0.tensors())
    print(f"    (a) one cluster's edge sets and degrees: {cluster_bytes} B")

    lap("a")

    # (b) one cluster step on the card against the same step on the CPU
    eh = config.model.edge_head
    cfg_b = dataclasses.replace(config, model=dataclasses.replace(
        config.model, dropout=0.0,
        edge_head=dataclasses.replace(eh, extras={**eh.extras, "bilinear_rank": CLUSTER_RANK, "bilinear_source": "embedding"}),
    ))
    model_gpu = build_model(cfg_b, graph_cpu, generator=torch.Generator().manual_seed(0))
    model_ref = build_model(cfg_b, graph_cpu, device="cpu", generator=torch.Generator().manual_seed(0))
    tr = MiniBatchTrainer(model_gpu, bundle, masker, cfg_b, CLUSTER_K, clusters=cd)
    tr_ref = MiniBatchTrainer(model_ref, bundle, masker, cfg_b, CLUSTER_K, device="cpu", clusters=cd)
    k = CLUSTER_K // 2
    b_gpu, g_gpu = tr._ensure_clusters().batches["train"][k][0], tr._ensure_clusters().subgraphs[k]
    b_ref, g_ref = tr_ref._ensure_clusters().batches["train"][k][0], tr_ref._ensure_clusters().subgraphs[k]
    sup = masker.supervision_mask(0, b_ref, cluster=k)
    reset_counts()
    t_step = time.perf_counter()
    loss = tr.train_step(b_gpu, sup.to(dev), 0, graph=g_gpu)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_step) * 1e3
    step_launches = counts_of()
    t_ref = time.perf_counter()
    loss_ref = tr_ref.train_step(b_ref, sup, 0, graph=g_ref)
    ref_s = time.perf_counter() - t_ref
    _compare(f"(b) cluster {k} step loss", torch.tensor(loss), torch.tensor(loss_ref), 0.0, STEP_LOSS_RTOL)
    params = dict(model_gpu.named_parameters())
    floor = STEP_GRAD_ZERO_FLOOR * max(float(p.grad.norm()) for p in model_ref.parameters())
    failed = [name for name, p in model_ref.named_parameters()
              if not _compare_norm(f"(b) grad {name}", params[name].grad, p.grad, STEP_GRAD_NORM_REL, floor)]
    if failed:
        raise AssertionError(f"(b) gradients outside tolerance: {failed}")
    for name, p in model_ref.named_parameters():
        diff = float((params[name].detach().cpu() - p.detach()).abs().max())
        if diff > STEP_PARAM_ATOL:
            raise AssertionError(f"(b) param {name}: max |d| {diff:.3e} > {STEP_PARAM_ATOL}")
    buffers = dict(model_gpu.named_buffers())
    for name, b in model_ref.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _compare(f"(b) bn {name}", buffers[name], b, STEP_BN_ATOL, STEP_BN_RTOL)
    # the step read the cluster's window of the global patient table
    # (its own patients and, through the BatchNorm statistics, the padding
    # rows past its range up to local_size)
    rows = params["embed_patient.weight"].grad.abs().sum(1).cpu()
    lo, hi, top = cd.bases[k], ends[k], cd.bases[k] + cd.local_size
    if not (float(rows[:lo].sum()) == 0.0 and float(rows[top:].sum()) == 0.0 and bool((rows[lo:hi] > 0).all())):
        raise AssertionError(f"(b) embed_patient's gradient is not confined to cluster {k}'s window [{lo}, {top})")
    on_path = {"segment_sum_windowed", "fused_table_segment_sum", "fused_table_segment_sum_bwd"}
    if not all(step_launches[n] for n in on_path) or step_launches["span_segment_sum"]:
        raise AssertionError(f"(b) launches {step_launches}: K1, K2f and K2b must launch and K3 must not")
    print(f"    (b) cluster {k} (base {lo}, patients to {hi}): loss {loss:.6f} (CPU plain {loss_ref:.6f}); "
          f"embed_patient's gradient only on its window [{lo}, {top}); launches {step_launches}; step {step_ms:.1f} ms on the card (first), "
          f"{ref_s:.1f} s on the CPU")
    del tr, tr_ref, model_gpu, model_ref, b_gpu, g_gpu

    # the same step in bfloat16, at phase 27's bounds: K1 and K2f launch
    # their bf16 instantiations, K2b takes float32 (JAX's fused-table
    # backward), K3 does not launch
    cfg_bb = dataclasses.replace(cfg_b, model=dataclasses.replace(cfg_b.model, compute_dtype="bfloat16"))
    model_gpu = build_model(cfg_bb, graph_cpu, generator=torch.Generator().manual_seed(0))
    model_ref = build_model(cfg_bb, graph_cpu, device="cpu", generator=torch.Generator().manual_seed(0))
    tr = MiniBatchTrainer(model_gpu, bundle, masker, cfg_bb, CLUSTER_K, clusters=cd)
    tr_ref = MiniBatchTrainer(model_ref, bundle, masker, cfg_bb, CLUSTER_K, device="cpu", clusters=cd)
    b_gpu, g_gpu = tr._ensure_clusters().batches["train"][k][0], tr._ensure_clusters().subgraphs[k]
    b_ref, g_ref = tr_ref._ensure_clusters().batches["train"][k][0], tr_ref._ensure_clusters().subgraphs[k]
    reset_counts()
    loss = tr.train_step(b_gpu, sup.to(dev), 0, graph=g_gpu)
    torch.cuda.synchronize()
    bf16_step = {n: sk.launch_counts[n + "_bf16"] for n in ("segment_sum_windowed", "fused_table_segment_sum",
                                                            "fused_table_segment_sum_bwd", "span_segment_sum")}
    f32_step = counts_of()
    loss_ref = tr_ref.train_step(b_ref, sup, 0, graph=g_ref)
    _compare(f"(b) bf16 cluster {k} step loss", torch.tensor(loss), torch.tensor(loss_ref), 0.0, BF16_LOSS_RTOL)
    _bf16_grads_close(f"(b) bf16 cluster {k} step, card vs CPU plain",
                      {n: p.grad for n, p in model_gpu.named_parameters()},
                      {n: p.grad for n, p in model_ref.named_parameters()})
    params = dict(model_gpu.named_parameters())
    for name, p in model_ref.named_parameters():
        diff = float((params[name].detach().cpu() - p.detach()).abs().max())
        if diff > STEP_PARAM_ATOL:
            raise AssertionError(f"(b) bf16 param {name}: max |d| {diff:.3e} > {STEP_PARAM_ATOL}")
    if not (bf16_step["segment_sum_windowed"] and bf16_step["fused_table_segment_sum"]
            and f32_step["fused_table_segment_sum_bwd"]) or bf16_step["span_segment_sum"] or f32_step["span_segment_sum"]:
        raise AssertionError(f"(b) bf16 launches {bf16_step}, float32 {f32_step}: K1 and K2f in bf16 and K2b in "
                             f"float32 must launch, K3 must not")
    print(f"    (b) bf16 cluster {k}: loss {loss:.6f} (CPU plain {loss_ref:.6f}); bf16 launches {bf16_step}; float32 "
          f"launches {f32_step}", flush=True)
    out["launches_bf16_cluster_step"] = bf16_step
    del tr, tr_ref, model_gpu, model_ref, b_gpu, g_gpu, b_ref, g_ref

    lap("b")

    # (c) each cluster-path kernel at its cluster shapes
    cd_small = build_patient_clusters(bundle, masker, config, CLUSTER_K_SMALL, lab_weights=lab_w, balance="patients")
    print(f"    (c) K {CLUSTER_K_SMALL} patients: local_size {cd_small.local_size}")
    sites = {f"K{CLUSTER_K} edges": _cluster_kernels(cd, f"(c) K {CLUSTER_K}", dev, d),
             f"K{CLUSTER_K_SMALL} patients": _cluster_kernels(cd_small, f"(c) K {CLUSTER_K_SMALL}", dev, d)}
    if "segment_sum_windowed" in sites[f"K{CLUSTER_K_SMALL} patients"]:
        raise AssertionError(f"(c) K {CLUSTER_K_SMALL}: a patient-source relation took K1, not the fused tier")
    # K1 as the backward of a cluster batch's patient gather: the rows'
    # upstream gradient (0 on padding slots, as the loss gives it), held as
    # per-row means (phase 7 holds K2b so)
    batch = cd.batches["train"][0][0].to(dev)
    plan = batch.patient_plan
    gb = torch.randn(batch.patient_idx.shape[0], d, generator=torch.Generator().manual_seed(7)).to(dev)
    gb *= batch.valid[:, None]
    args = (plan.win_src, plan.win_local, plan.win_tile_map, plan.num_windows)
    kern = lambda: sk.segment_sum_windowed(gb, *args)  # noqa: E731
    plain = lambda: sk.segment_sum_windowed_plain(gb, *args)  # noqa: E731
    idx = batch.patient_idx.long()
    per_row = torch.bincount(idx, minlength=plan.num_rows).clamp_min(1).double()[:, None]
    lib = lambda: torch.zeros(plan.num_rows, d, device=dev).index_add_(0, idx, gb)  # noqa: E731
    max_abs, _ = _compare("(c) K1 as the cluster batch's patient-gather backward (per-row means)",
                          kern()[: plan.num_rows] / per_row, plain()[: plan.num_rows] / per_row,
                          KERNEL_ATOL, KERNEL_RTOL)
    bound = _bound(_nbytes(gb, *args[:3]) + plan.num_rows * d * 4, batch.patient_idx.shape[0] * d)
    gsite = {"max_abs_err": max_abs, "ms": _median_ms(kern), "plain_ms": _median_ms(plain), **bound,
             "library_ms": _library_ms("(c) index_add_ of the gather's rows", lib)}
    print(f"    (c) K1 as the gather backward ({batch.patient_idx.shape[0]} rows onto {plan.num_rows}): "
          f"kernel {gsite['ms']:.4f} ms  plain {gsite['plain_ms']:.4f}  bound {bound['bound_ms']:.4f} ({bound['bound_by']})")
    sites[f"K{CLUSTER_K} edges"].setdefault("segment_sum_windowed", {})["gather backward (patients)"] = gsite
    del cd_small, batch, gb

    lap("c")

    # (d) K = 1 against full batch on a window-aligned cohort
    cfg_d = dataclasses.replace(
        config, model=dataclasses.replace(config.model, dropout=0.0),
        train=dataclasses.replace(config.train, mask_fraction=0.0),
    )
    spec = dataclasses.replace(SyntheticSpec.scale_100k(seed=0), num_patients=K1_PATIENTS)
    graph_d_cpu = make_synthetic_graph(spec, cfg_d, device="cpu")
    graph_d = graph_d_cpu.to(dev)
    masker_d = masker_from_config(cfg_d, graph_d_cpu)
    def full_run():
        full = Trainer(build_model(cfg_d, graph_d_cpu, generator=torch.Generator().manual_seed(2)), graph_d,
                       masker_d, cfg_d)
        losses = full.train_epochs(CLUSTER_EPOCHS, with_val=True)
        return losses, torch.from_numpy(full.predict("test"))

    fulls = [full_run() for _ in range(K1_FULL_RUNS)]
    (lf, vf), pred_full = fulls[0]
    bundle_d = GraphBundle(graph=graph_d, meta=GraphMeta(), host_edges=host_edges_of(graph_d_cpu))
    one = MiniBatchTrainer(build_model(cfg_d, graph_d_cpu, generator=torch.Generator().manual_seed(2)), bundle_d,
                           masker_d, cfg_d, 1)
    l1, v1 = one.train_epochs(CLUSTER_EPOCHS, with_val=True)
    print(f"    (d) {K1_PATIENTS} patients, {graph_d_cpu.edges[PATIENT_LAB].num_valid} patient-lab edges: "
          f"full batch train {lf.tolist()} val {vf.tolist()}; K = 1 train {l1.tolist()} val {v1.tolist()}")
    _compare("(d) first epoch's loss, K = 1 vs full batch", torch.tensor(l1[:1]), torch.tensor(lf[:1]), 0.0, STEP_LOSS_RTOL)
    _compare(f"(d) epoch {CLUSTER_EPOCHS}'s loss", torch.tensor(l1[-1:]), torch.tensor(lf[-1:]), K1_ATOL, K1_RTOL)
    _compare("(d) validation loss", torch.tensor(v1[-1:]), torch.tensor(vf[-1:]), K1_ATOL, K1_RTOL)
    pred_one = torch.from_numpy(one.predict("test"))
    pred_err = float((pred_one - pred_full).abs().max())
    pred_drift = max(float((a[1] - b[1]).abs().max()) for i, a in enumerate(fulls) for b in fulls[i + 1:])
    over = int(((pred_one - pred_full).abs() > K1_ATOL + K1_RTOL * pred_full.abs()).sum())
    print(f"    (d) test predictions: K = 1 vs full batch max |d| {pred_err:.3e} (max|ref| "
          f"{float(pred_full.abs().max()):.3e}; {over} of {len(pred_full)} over JAX's elementwise 1e-5 + 1e-4 |ref|); "
          f"{K1_FULL_RUNS} full-batch runs differ by up to {pred_drift:.3e}")
    if not pred_err <= 2 * pred_drift:
        raise AssertionError(f"(d) K = 1's test predictions differ from full batch's by {pred_err:.3e}, over twice "
                             f"the drift of full-batch runs ({pred_drift:.3e})")
    del fulls, one, graph_d, graph_d_cpu, bundle_d, masker_d
    torch.cuda.empty_cache()

    lap("d")

    # (e) host-resident against device-resident, K = 8
    def peak_run(make, epochs=CLUSTER_EPOCHS, count=False, keep=False):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = make()
        if count:
            reset_counts()
        times, losses, vals, launches = [], [], [], None
        for i in range(epochs):
            t_ep = time.perf_counter()
            tl, vl = trainer.train_epochs(1, with_val=True)
            times.append((time.perf_counter() - t_ep) * 1e3)
            losses.append(float(tl[0]))
            vals.append(float(vl[0]))
            if count and i == 0:  # the launches of one epoch (its steps and its validation)
                launches = counts_of()
        peak = torch.cuda.max_memory_allocated() - before
        run = dict(train=losses, val=vals, ms=times, peak=peak, launches=launches,
                   absolute=torch.cuda.max_memory_allocated())
        return (trainer, run) if keep else run

    # every trainer gets the full graph already on the card, so no peak
    # below counts a copy of it
    bundle_dev = GraphBundle(graph=graph, meta=GraphMeta(), host_edges=bundle.host_edges)

    def cluster_trainer(host):
        return lambda: MiniBatchTrainer(build_model(config, graph_cpu, generator=torch.Generator().manual_seed(4)),
                                        bundle_dev, masker, config, CLUSTER_K, host_resident=host, clusters=cd)

    full_run = peak_run(lambda: Trainer(build_model(config, graph_cpu, generator=torch.Generator().manual_seed(4)),
                                        graph, masker, config))
    def resident_sample(make, n_dev, n_host):
        """n_dev device- and n_host host-resident runs from one init, in
        turns (a host-resident run after every n_dev // n_host device-resident
        ones); the last host-resident trainer is kept."""
        dev, host, kept = [], [], None
        for i in range(n_dev):
            dev.append(peak_run(make(False), count=i == 0))
            if (i + 1) % (n_dev // n_host) == 0 and len(host) < n_host:
                kept = None
                kept, run = peak_run(make(True), keep=True)
                host.append(run)
        return dev, host, kept

    dev_runs, host_runs, host_tr = resident_sample(cluster_trainer, CLUSTER_DEVICE_RUNS, CLUSTER_HOST_RUNS)
    dev_run, host_run = dev_runs[0], host_runs[-1]
    for label, run in (("full batch", full_run), *((f"device-resident {i + 1}", r) for i, r in enumerate(dev_runs)),
                       *((f"host-resident {i + 1}", r) for i, r in enumerate(host_runs))):
        print(f"    (e) {label}: train {run['train']} val {run['val']}; epochs {', '.join('%.1f' % t for t in run['ms'])} "
              f"ms; peak {run['peak'] / 2**30:.3f} GiB above what was allocated before "
              f"({run['absolute'] / 2**30:.3f} GiB in all)")

    from multi_modal_gnn_tpu_torch.tools.cluster_drift import rel_drift

    # the drift of device-resident runs from one init (the kernels' atomics):
    # the largest over the pairs of CLUSTER_DEVICE_RUNS runs.  Host- and
    # device-resident runs drift from one population (10 + 10 runs of
    # tools/cluster_drift.py on the H100), so each host-resident run is held
    # to twice that spread of the larger sample
    drift = max(rel_drift(a, b) for i, a in enumerate(dev_runs) for b in dev_runs[i + 1:])
    sample = {"device": [rel_drift(r, dev_run) for r in dev_runs[1:]], "host": [rel_drift(r, dev_run) for r in host_runs]}
    host_drift = max(sample["host"])
    print(f"    (e) the sample, each run's relative drift from device-resident run 1: device "
          f"{', '.join('%.3e' % v for v in sample['device'])}; host {', '.join('%.3e' % v for v in sample['host'])}")
    if not host_drift <= 2 * drift:
        raise AssertionError(f"(e) host-resident differs from device-resident by {host_drift:.3e} (relative), "
                             f"over twice the drift of {CLUSTER_DEVICE_RUNS} device-resident runs ({drift:.3e})")
    saved = dev_run["peak"] - host_run["peak"]
    need = (CLUSTER_K - 3) * cluster_bytes
    if saved < need:
        raise AssertionError(f"(e) host-resident's peak is {saved} B below device-resident's, less than "
                             f"{CLUSTER_K - 3} clusters' edge sets ({need} B)")
    print(f"    (e) launches in one device-resident epoch ({CLUSTER_K} steps and the validation): {dev_run['launches']}")
    print(f"    (e) host-resident vs device-resident: {host_drift:.3e} (relative, the largest of {CLUSTER_HOST_RUNS}) <= "
          f"2 x drift {drift:.3e} ({CLUSTER_DEVICE_RUNS} runs); peak "
          f"{saved} B lower >= {CLUSTER_K - 3} x {cluster_bytes} B")
    from torch.profiler import ProfilerActivity, profile

    host_tr.train_epochs(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_tr.train_epochs(1)
        torch.cuda.synchronize()
    share, copy_ms, n_copies, busy_ms, span_ms = _copy_overlap(prof)
    print(f"    (e) profiled host-resident epoch: {n_copies} host-to-device copies, {copy_ms:.3f} ms; share of copy time "
          f"overlapping kernels {share:.4f}; kernels busy {busy_ms:.3f} ms of the trace's {span_ms:.3f} ms on the "
          f"device (idle {1 - busy_ms / max(span_ms, 1e-9):.4f})")
    del host_tr
    torch.cuda.empty_cache()

    lap("e")

    # (f) the HGT, K = 16, host-resident
    hgt_cfg = dataclasses.replace(config, model=dataclasses.replace(config.model, architecture="HGT", num_heads=HGT_HEADS))
    bundle_h = GraphBundle(graph=graph_hgt, meta=GraphMeta(), host_edges=bundle.host_edges)
    hgt_model = build_model(hgt_cfg, graph_cpu, generator=torch.Generator().manual_seed(6))
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hgt = MiniBatchTrainer(hgt_model, bundle_h, masker, hgt_cfg, CLUSTER_K_HGT, host_resident=True)
    val0 = hgt.validate()
    hcd = hgt._ensure_clusters()
    tiers = {dst: hgt.model.hgt_0.tier(hcd.subgraphs[0], dst) for dst in hgt.model.hgt_0.groups()}
    if set(tiers.values()) != {"segment"}:
        raise AssertionError(f"(f) cluster tiers {tiers}: the HGT's clusters carry no attention plan")
    h_ms, h_losses = [], []
    for _ in range(CLUSTER_HGT_EPOCHS):
        t_ep = time.perf_counter()
        tl, vl = hgt.train_epochs(1, with_val=True)
        h_ms.append((time.perf_counter() - t_ep) * 1e3)
        h_losses.append((float(tl[0]), float(vl[0])))
    h_peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for pair in h_losses for x in pair) or not h_losses[-1][1] < val0:
        raise AssertionError(f"(f) HGT losses {h_losses}: not finite, or the validation loss not below {val0:.6f}")
    print(f"    (f) HGT K {CLUSTER_K_HGT} host-resident: tier per cluster {tiers} (every cluster alike: no plans); "
          f"untrained val {val0:.6f}; (train, val) {h_losses}; epochs {', '.join('%.1f' % t for t in h_ms)} ms; "
          f"peak {h_peak / 2**30:.2f} GiB ({(h_peak - before) / 2**30:.2f} above what was allocated before) against "
          f"the full-batch segment tier's {HGT_SEGMENT_PEAK_GIB} GiB")
    del hgt, hgt_model, bundle_h
    torch.cuda.empty_cache()

    lap("f")

    # (g) the bench, in bfloat16 (bench --bf16 --clusters 8; the float32
    # cluster path is (e)'s)
    # phase 3's graph is the bench's (scale_100k, no dense tier, span 256): not built again
    result = bench.run_bench(scale=True, dense=False, quick=True, clusters=CLUSTER_K, bf16=True, graph=graph)
    print("    (g) " + json.dumps(result), flush=True)
    if result.get("clusters") != CLUSTER_K or result["compute_dtype"] != "bfloat16" or not result["value"] > 0:
        raise AssertionError(f"(g) the bench line: {result}")
    if not all(result["kernel_launches"].get(n) for n in ("segment_sum_windowed_bf16", "fused_table_segment_sum_bf16")):
        raise AssertionError(f"(g) the bf16 cluster bench did not launch K1 / K2f in bf16: {result['kernel_launches']}")

    lap("g")

    # (h) bfloat16 at K = 8: K1 / K2f (bf16) and K2b at the cluster sites in
    # turns with their float32 launches; device- against host-resident runs
    # from one init under (e)'s check
    sites_bf16 = {f"K{CLUSTER_K} edges": _cluster_kernels_bf16(cd, f"(h) K {CLUSTER_K}", dev, d)}
    cfg_h = dataclasses.replace(config, model=dataclasses.replace(config.model, compute_dtype="bfloat16"))

    def bf16_trainer(host):
        return lambda: MiniBatchTrainer(build_model(cfg_h, graph_cpu, generator=torch.Generator().manual_seed(4)),
                                        bundle_dev, masker, cfg_h, CLUSTER_K, host_resident=host, clusters=cd)

    dev_bf, host_bf, _ = resident_sample(bf16_trainer, CLUSTER_DEVICE_RUNS_BF16, CLUSTER_HOST_RUNS_BF16)
    drift_bf = max(rel_drift(a, b) for i, a in enumerate(dev_bf) for b in dev_bf[i + 1:])
    host_drift_bf = max(rel_drift(r, dev_bf[0]) for r in host_bf)
    for label, run in (*((f"device-resident {i + 1}", r) for i, r in enumerate(dev_bf)),
                       *((f"host-resident {i + 1}", r) for i, r in enumerate(host_bf))):
        print(f"    (h) bf16 {label}: train {run['train']} val {run['val']}; epochs "
              f"{', '.join('%.1f' % t for t in run['ms'])} ms; peak {run['peak'] / 2**30:.3f} GiB")
    print(f"    (h) bf16 host-resident vs device-resident: {host_drift_bf:.3e} (relative) <= 2 x drift {drift_bf:.3e} "
          f"({CLUSTER_DEVICE_RUNS_BF16} runs)", flush=True)
    if not host_drift_bf <= 2 * drift_bf:
        raise AssertionError(f"(h) bf16 host-resident differs from device-resident by {host_drift_bf:.3e}, over "
                             f"twice the drift of device-resident runs ({drift_bf:.3e})")
    if not all(math.isfinite(x) for r in (*dev_bf, *host_bf) for key in ("train", "val") for x in r[key]):
        raise AssertionError("(h) non-finite bf16 cluster losses")

    lap("h")
    out.update(
        launches_cluster_epoch=dev_run["launches"], sites=sites, sites_bf16=sites_bf16, summary=dict(
            build_s=build_s, cluster_bytes=cluster_bytes, drift=drift, host_drift=host_drift, sample=sample,
            drift_bf16=drift_bf, host_drift_bf16=host_drift_bf,
            peaks={"full": full_run["peak"], "device": dev_run["peak"], "host": host_run["peak"]},
            epoch_ms={"full": full_run["ms"], "device": dev_run["ms"], "host": host_run["ms"]},
            overlap=share, hgt_peak=h_peak, hgt_ms=h_ms, bench=result["value"],
            k1_pred_err=pred_err, k1_pred_drift=pred_drift,
        ),
    )
    return out


def _cluster_quality_phase(dev) -> dict:
    """Phase 26: JAX's K > 1 quality pin on the card with the port."""
    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec
    from multi_modal_gnn_tpu_torch.data.synthetic import generate_synthetic_tables
    from multi_modal_gnn_tpu_torch.evaluation.metrics import compute_regression_metrics
    from multi_modal_gnn_tpu_torch.graph.build import build_heterogeneous_graph
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.training import (
        EdgeMasker, MiniBatchTrainer, Trainer, bundle_membership_matrix, warm_start_trainer,
    )
    from multi_modal_gnn_tpu_torch.utils.rng import stream_seed

    cfg = Config()
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, edge_head=dataclasses.replace(
            cfg.model.edge_head, extras={"bilinear_rank": 17, "bilinear_source": "embedding"})),
        train=dataclasses.replace(
            cfg.train, loss="mse", epochs=QUALITY_EPOCHS, early_stopping_patience=10**9,
            optimizer=dataclasses.replace(cfg.train.optimizer, lr=1e-4),
            lr_scheduler=dataclasses.replace(cfg.train.lr_scheduler, enabled=False),
        ),
    )
    spec = dataclasses.replace(SyntheticSpec.eicu_demo(), seed=0, signal_strength=0.6)
    t = generate_synthetic_tables(spec)
    bundle = build_heterogeneous_graph(
        t["labs_normalized"], t["diagnoses"], t["medications"], t["cohort"], t["labitems"], cfg
    )
    memberships = bundle_membership_matrix(bundle)
    runs = {}
    for k, dtype in ((1, "float32"), (4, "float32"), (4, "bfloat16")):
        t_run = time.perf_counter()
        masker = EdgeMasker(bundle.graph, seed=42)
        cfg_k = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))
        model = build_model(cfg_k, bundle.graph,
                            generator=torch.Generator().manual_seed(stream_seed(cfg.train.seed, "init")))
        tr = Trainer(model, bundle.graph, masker, cfg_k) if k == 1 else MiniBatchTrainer(model, bundle, masker, cfg_k, k)
        warm_start_trainer(tr, rank=8, reg=12.0, memberships=memberships)
        for _ in range(QUALITY_EPOCHS):
            tr.train_epoch()
            val = tr.validate()
            if val < tr.best_val_loss:
                tr.best_val_loss = val
                tr.best_state = copy.deepcopy(tr.model.state_dict())
            tr.epoch += 1
        _, _, te_v = masker.split_arrays("test")
        r2 = compute_regression_metrics(tr.predict("test", state=tr.best_state).astype(np.float64), te_v)["r2"]
        runs[(k, dtype)] = r2
        print(f"    K = {k}, {dtype}: test R2 {r2:.6f} (best val loss {tr.best_val_loss:.6f}); "
              f"{time.perf_counter() - t_run:.1f} s", flush=True)
    r2_full, r2_k4, r2_k4_bf16 = runs[(1, "float32")], runs[(4, "float32")], runs[(4, "bfloat16")]
    if not (r2_full >= QUALITY_R2_MIN and r2_k4 >= QUALITY_R2_MIN and abs(r2_full - r2_k4) <= QUALITY_R2_GAP):
        raise AssertionError(f"cluster quality: R2 K=1 {r2_full:.4f}, K=4 {r2_k4:.4f} (JAX's criterion: both >= "
                             f"{QUALITY_R2_MIN}, |gap| <= {QUALITY_R2_GAP})")
    if not abs(r2_k4 - JAX_CPU_R2_K4) <= QUALITY_JAX_MARGIN:
        raise AssertionError(f"cluster quality: K=4 R2 {r2_k4:.4f} outside {JAX_CPU_R2_K4:.4f} +- {QUALITY_JAX_MARGIN}")
    # the same K = 4 recipe in bfloat16: JAX's bar, and within bf16's noise
    # budget of the float32 run above
    if not (r2_k4_bf16 >= QUALITY_R2_MIN and abs(r2_k4_bf16 - r2_k4) <= BF16_NOISE_BUDGET):
        raise AssertionError(f"cluster quality in bf16: K=4 R2 {r2_k4_bf16:.4f} (>= {QUALITY_R2_MIN}, within "
                             f"{BF16_NOISE_BUDGET} of float32's {r2_k4:.4f})")
    return {"r2_k1": r2_full, "r2_k4": r2_k4, "r2_k4_bf16": r2_k4_bf16}


def _bf16_close(name: str, got, want) -> float:
    """A gradient that leaves in bfloat16 (constants above): returns the
    largest error."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} / {tuple(want.shape)} or non-finite values")
    err, scale = (got - want).abs(), float(want.abs().max())
    off = float((err > 1e-4 * scale).double().mean()) if err.numel() else 0.0
    ok = float(err.max()) <= BF16_ULP * scale and off <= BF16_FLIP_SHARE
    print(f"    {name}: max_abs_err {float(err.max()):.3e}  max|ref| {scale:.3e}  beyond 1e-4 max|ref|: {off:.2e} "
          f"of the elements (<= {BF16_FLIP_SHARE:g}, each <= 2^-7 max|ref|)  {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: outside tolerance")
    return float(err.max())


def _bf16_grads_close(name: str, got: dict, want: dict, zero=None) -> None:
    """A bfloat16 step's gradients against another bfloat16 step's, per
    tensor: ``||got - want|| <= BF16_STEP_GRAD_NORM_REL * ||want||`` plus
    1e-6 of the step's largest gradient norm.  A bias right before a
    BatchNorm (``zero``, default :func:`_feeds_batch_norm`) has a gradient of
    0 in exact arithmetic: each side holds its own rounding noise, and
    ``got``'s is held to twice ``want``'s."""
    import torch

    largest = max(float(g.norm()) for g in want.values())
    floor = STEP_GRAD_ZERO_FLOOR * largest
    drift, failed = {}, []
    zero = zero or _feeds_batch_norm
    for key, ref in want.items():
        a, b = got[key].double().cpu(), ref.double().cpu()
        if zero(key):
            ok = float(a.norm()) <= 2 * float(b.norm()) + floor
        else:
            diff, norm = float(torch.linalg.vector_norm(a - b)), float(torch.linalg.vector_norm(b))
            ok = diff <= BF16_STEP_GRAD_NORM_REL * norm + floor
            drift[key] = diff / norm if norm > 0 else 0.0
        if not ok:
            failed.append(key)
    top = sorted(drift.items(), key=lambda kv: -kv[1])[:6]
    print(f"    {name}: ||d|| / ||ref|| largest " + ", ".join(f"{k} {v:.3e}" for k, v in top)
          + f" (<= {BF16_STEP_GRAD_NORM_REL}); {len(want) - len(drift)} BatchNorm-fed biases within twice the "
          f"reference's noise; {'ok' if not failed else 'FAIL ' + str(failed)}", flush=True)
    if failed:
        raise AssertionError(f"{name}: gradients outside the bound: {failed}")


def _feeds_batch_norm(name: str) -> bool:
    """A bias added right before a BatchNorm (the encoder's hidden layers,
    the convolutions' summed neighbor biases)."""
    return name.endswith(".bias") and (
        name.startswith("conv_") or name in ("patient_encoder.dense_0.bias", "patient_encoder.dense_1.bias")
    )


def _vctx_rgcn_zero(name: str) -> bool:
    """The value-context RGCN's parameters with a gradient of 0 in exact
    arithmetic: the BatchNorm-fed biases and the value-context biases
    (each shifts every patient or lab row alike, and those rows reach the
    loss only through mean aggregations into BatchNorm;
    tests/test_torch_bf16_slice.py)."""
    return _feeds_batch_norm(name) or name in ("vctx_patient.bias", "vctx_lab.bias")


def _bf16_state_close(name: str, got, want, f32) -> float:
    """Node state and answers in bfloat16, card against the CPU plain
    versions: ``||got - want|| <= BF16_STATE_RATIO * ||want - f32||`` (the
    two sides' disagreement well under bfloat16's own effect, ``f32`` the
    same weights in float32; tests/test_torch_bf16.py's bound).  Returns
    the ratio."""
    import torch

    got, want, f32 = got.double().cpu(), want.double().cpu(), f32.double().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} / {tuple(want.shape)} or non-finite values")
    diff, effect = float(torch.linalg.vector_norm(got - want)), float(torch.linalg.vector_norm(want - f32))
    ratio = diff / effect if effect > 0 else (0.0 if diff == 0 else float("inf"))
    ok = ratio <= BF16_STATE_RATIO
    print(f"    {name}: ||card - CPU|| / ||bf16 - f32|| {ratio:.3e}  max_abs_err {float((got - want).abs().max()):.3e}  "
          f"(<= {BF16_STATE_RATIO})  {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: outside tolerance")
    return ratio


def _bf16_phase(dev, graph_cpu, graph, graph_hgt, config, hgt_config, dual_config, tiers, masker, masker0,
                flagship_r2_f32, reset_counts, flag_run, flag_dir) -> dict:
    """Phase 27: the bfloat16 compute path (model.compute_dtype: bfloat16 |
    auto) on phase 3's graph.  Returns each kernel's bfloat16 results and
    launches for the kernels line."""
    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch.data import SyntheticSpec
    from multi_modal_gnn_tpu_torch.data.synthetic import generate_synthetic_tables
    from multi_modal_gnn_tpu_torch.evaluation.metrics import compute_regression_metrics
    from multi_modal_gnn_tpu_torch.graph.build import build_heterogeneous_graph
    from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW, pad_edge_set
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.ops import _build
    from multi_modal_gnn_tpu_torch.ops import pairhead_kernels as pk
    from multi_modal_gnn_tpu_torch.ops import segment as seg_ops
    from multi_modal_gnn_tpu_torch.ops import segment_kernels as sk
    from multi_modal_gnn_tpu_torch.serving import build_serving_fn, compute_node_state, predict_patient
    from multi_modal_gnn_tpu_torch.tools import bench
    from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer, warm_start_trainer
    from multi_modal_gnn_tpu_torch.utils import mxu_probe
    from multi_modal_gnn_tpu_torch.utils.rng import stream_seed

    bf, d = torch.bfloat16, config.model.hidden_dim
    gen = torch.Generator().manual_seed(27)
    out = {"kernels": {}, "launches_step": {}}

    def bf16_counts():
        counts = {**sk.launch_counts, **pk.launch_counts}
        return {name: counts[name + "_bf16"] for name in (*SEGMENT_KERNELS, "pair_head_fwd", "pair_head_bwd",
                                                          "pair_head_dual_fwd", "pair_head_dual_bwd")}

    def with_dtype(cfg, dtype, **model):
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype, **model))

    for label, entry in BF16_NAMED:
        print(f"    ptxas bf16 {label}: " + (" | ".join(_ptxas_report(_build.build_log, entry)) or "not built in this run"))

    # (a) the tensor-core probe, called directly: a probe that fails fails the phase
    stats = mxu_probe.probe_bf16_stats(force=True)
    print(f"    (a) probe: t_f32 {stats['t_f32_ms']} ms, t_bf16 {stats['t_bf16_ms']} ms (32 dependent [2048, 2048] "
          f"matmuls, median of 7, {stats['repeats']} pairs); ratio {stats['ratio']}, ratio_min {stats['ratio_min']}, "
          f"ratio_max {stats['ratio_max']}", flush=True)
    want_auto = bf if stats["ratio_min"] >= mxu_probe.BF16_ENGAGE_RATIO else None
    auto_model = build_model(with_dtype(config, "auto"), graph_cpu, generator=torch.Generator().manual_seed(0))
    if auto_model.compute_dtype != want_auto:
        raise AssertionError(f"compute_dtype auto built {auto_model.compute_dtype}, the rule says {want_auto}")
    print(f"    (a) compute_dtype auto -> {auto_model.compute_dtype or torch.float32} (engage at ratio_min >= "
          f"{mxu_probe.BF16_ENGAGE_RATIO})")
    out["probe"] = stats
    del auto_model

    # (c) one RGCN train step in bfloat16 (dropout 0), the card against the
    # CPU plain versions; K1's call sites recorded as phase 8 does
    cfg_bf = with_dtype(config, "bfloat16", dropout=0.0)
    model_gpu = build_model(cfg_bf, graph_cpu, generator=torch.Generator().manual_seed(0))
    model_ref = build_model(cfg_bf, graph_cpu, device="cpu", generator=torch.Generator().manual_seed(0))
    # (d) the bf16 node state and the three request types of the same
    # weights, card against CPU plain (before the step moves them)
    model_f32 = build_model(with_dtype(cfg_bf, "float32"), graph_cpu, generator=torch.Generator().manual_seed(0))
    state = compute_node_state(model_gpu, graph)
    state_ref = compute_node_state(model_ref, graph_cpu)
    state_f32 = compute_node_state(model_f32, graph)
    for key, value in state_ref.items():
        if value.is_floating_point() and key != "degree":
            _bf16_state_close(f"(d) state {key} ({state[key].dtype})", state[key], value, state_f32[key])
    fn, _ = build_serving_fn(model_gpu, graph, state)
    fn_ref, _ = build_serving_fn(model_ref, graph_cpu, state_ref)
    fn_f32, _ = build_serving_fn(model_f32, graph, state_f32)
    num_l = graph.num_nodes("lab")
    rng = np.random.default_rng(27)
    requests = {"patient 17": None, "batch 256": 256, "batch 4096": 4096}
    for label, n in requests.items():
        if n is None:
            got, want, ref32 = (predict_patient(f, 17, num_l) for f in (fn, fn_ref, fn_f32))
        else:
            p, l = rng.integers(0, graph.num_nodes("patient"), n), rng.integers(0, num_l, n)
            got, want, ref32 = fn(p, l), fn_ref(p, l), fn_f32(p, l)
        if got.dtype != torch.float32:
            raise AssertionError(f"(d) {label}: answers in {got.dtype}, not float32")
        _bf16_state_close(f"(d) request {label}", got, want, ref32)
    del state_ref, fn_ref, model_f32, state_f32, fn_f32
    trainer, trainer_ref = Trainer(model_gpu, graph, masker, cfg_bf), Trainer(model_ref, graph_cpu, masker, cfg_bf, device="cpu")
    batch_cpu = masker.get_split("train")
    sup = masker.supervision_mask(0, batch_cpu)
    b_gpu, b_ref = trainer.get_batch("train"), trainer_ref.get_batch("train")
    plan_of = {es.win_local.data_ptr(): et for et, es in graph.edges.items() if es.win_local is not None}
    k1_calls, k1_real = [], seg_ops.segment_sum_windowed

    def k1_recorded(x, idx, win_local, win_tile_map, num_windows):
        k1_calls.append((plan_of.get(win_local.data_ptr()), x.dtype))
        return k1_real(x, idx, win_local, win_tile_map, num_windows)

    reset_counts()
    seg_ops.segment_sum_windowed = k1_recorded
    try:
        loss = trainer.train_step(b_gpu, sup.to(dev), 0)
        torch.cuda.synchronize()
    finally:
        seg_ops.segment_sum_windowed = k1_real
    step_bf16 = bf16_counts()
    step_f32 = {name: n for name, n in {**sk.launch_counts, **pk.launch_counts}.items() if not name.endswith("_bf16")}
    grads_gpu = {n: p.grad.detach().clone() for n, p in model_gpu.named_parameters()}
    t_ref = time.perf_counter()
    loss_ref = trainer_ref.train_step(b_ref, sup, 0)
    ref_s = time.perf_counter() - t_ref
    _compare("(c) bf16 train step loss", torch.tensor(loss), torch.tensor(loss_ref), 0.0, BF16_LOSS_RTOL)
    grads_ref = {n: p.grad.detach() for n, p in model_ref.named_parameters()}
    _bf16_grads_close("(c) bf16 step, card vs CPU plain", grads_gpu, grads_ref)
    params = dict(model_gpu.named_parameters())
    for name, p in model_ref.named_parameters():
        diff = float((params[name].detach().cpu() - p.detach()).abs().max())
        if diff > STEP_PARAM_ATOL:
            raise AssertionError(f"bf16 param {name}: max |d| {diff:.3e} > {STEP_PARAM_ATOL}")
    print(f"    (c) params after Adam within {STEP_PARAM_ATOL:g}; CPU plain step {ref_s:.1f} s; bf16 launches "
          f"{step_bf16}; float32 launches {step_f32} (K2b takes the float32 scaled gradient, as JAX's "
          f"fused-table backward does)", flush=True)
    for name in ("segment_sum_windowed", "fused_table_segment_sum", "span_segment_sum", "pair_head_fwd", "pair_head_bwd"):
        if not step_bf16[name]:
            raise AssertionError(f"{name}_bf16 did not launch in the bf16 step: {step_bf16}")
    if any(dtype != bf for _, dtype in k1_calls):
        raise AssertionError(f"K1 took float32 rows in the bf16 step: {k1_calls}")
    # the same step with both heads in one call (dual on, lab_tile_rows 0)
    # against dual off on that batch, both on the card
    losses, grads = {}, {}
    for key in ("on", "off"):
        cfg_d = with_dtype(dual_config, "bfloat16", dropout=0.0, extras={"dual_head_fusion": key})
        model = build_model(cfg_d, graph_cpu, generator=torch.Generator().manual_seed(0))
        tr = Trainer(model, graph, masker0, cfg_d)
        b0 = tr.get_batch("train")
        reset_counts()
        losses[key] = tr.train_step(b0, masker0.supervision_mask(0, masker0.get_split("train")).to(dev), 0)
        torch.cuda.synchronize()
        if key == "on":
            dual_counts = bf16_counts()
        grads[key] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        del model, tr
    _compare("(c) bf16 step, dual on vs off: loss", torch.tensor(losses["on"]), torch.tensor(losses["off"]), 0.0,
             BF16_LOSS_RTOL)
    _bf16_grads_close("(c) bf16 step, dual on vs off", grads["on"], grads["off"])
    if not (dual_counts["pair_head_dual_fwd"] and dual_counts["pair_head_dual_bwd"]):
        raise AssertionError(f"bf16 dual step: K5 did not launch: {dual_counts}")
    out["launches_step"] = {n: step_bf16[n] + dual_counts[n] for n in step_bf16}
    print(f"    (c) dual-on bf16 step launches {dual_counts}", flush=True)

    del model_ref, trainer_ref

    # (b) each kernel against its plain version in bfloat16 at the path's
    # shapes, timed in turns with its float32 kernel (bf16, f32, f32, bf16)
    # beside its bound for 2-byte rows
    def turns(name, kernel_bf16, kernel_f32, plain_bf16, nbytes, flops, max_abs, peak=FP32_FLOPS):
        t = [_median_ms(kernel_bf16), _median_ms(kernel_f32), _median_ms(kernel_f32), _median_ms(kernel_bf16)]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        entry = {"max_abs_err": max_abs, "ms": (t[0] + t[3]) / 2, "f32_ms": (t[1] + t[2]) / 2, "turns_ms": t,
                 "plain_ms": _median_ms(plain_bf16, 5), "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"    (b) {name}: turns bf16, f32, f32, bf16 {', '.join('%.4f' % x for x in t)} ms; plain "
              f"{entry['plain_ms']:.4f} ms; bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, 2-byte rows)",
              flush=True)
        return entry

    def mean_of(total, es):
        return total[: es.num_dst] / es.dst_count.clamp_min(1.0)[:, None]

    def seg_site(kind, et, es, rows, args, kernel, plain, out_rows):
        x = torch.randn(rows, d, generator=gen).to(dev)
        xb = x.to(bf)
        got, want = kernel(xb, *args), plain(xb, *args)
        if kind == "K2b":
            per = torch.bincount(es.win_src[es.win_local < WINDOW].long(), minlength=es.num_src).clamp_min(1)[:, None]
            max_abs, _ = _compare(f"(b) bf16 {kind} on {'/'.join(et)}", got / per, want / per, KERNEL_ATOL, KERNEL_RTOL)
        else:
            max_abs, _ = _compare(f"(b) bf16 {kind} on {'/'.join(et)}", mean_of(got, es), mean_of(want, es),
                                  KERNEL_ATOL, KERNEL_RTOL)
        nbytes = _nbytes(xb, *[a for a in args if isinstance(a, torch.Tensor)]) + out_rows * d * 4
        return turns(f"{kind} on {'/'.join(et)}", lambda: kernel(xb, *args), lambda: kernel(x, *args),
                     lambda: plain(xb, *args), nbytes, es.num_valid * d, max_abs)

    k1_sites = {}
    if any(et is None for et, _ in k1_calls):
        raise AssertionError(f"K1 ran outside the graph's windowed plans in the bf16 step: {k1_calls}")
    for et in sorted(set(et for et, _ in k1_calls), key=lambda et: -graph.edges[et].num_valid):
        es = graph.edges[et]
        args = (es.win_src, es.win_local, es.win_tile_map, es.num_windows)
        k1_sites["/".join(et)] = seg_site("K1", et, es, es.num_src, args, sk.segment_sum_windowed,
                                           sk.segment_sum_windowed_plain, es.num_windows * WINDOW)
        k1_sites["/".join(et)]["calls_per_step"] = sum(1 for e, _ in k1_calls if e == et)
    k2f, k2b = {}, {}
    for et in sorted((et for et, t in tiers.items() if t == "fused_table"), key=lambda et: -graph.edges[et].num_valid):
        es = graph.edges[et]
        k2f["/".join(et)] = seg_site("K2f", et, es, es.num_src, (es.win_src, es.win_local, es.win_tile_map, es.num_windows),
                                     sk.fused_table_segment_sum, sk.fused_table_segment_sum_plain, es.num_windows * WINDOW)
        k2b["/".join(et)] = seg_site("K2b", et, es, es.num_dst, (es.win_src, es.win_local, es.win_tile_map, es.num_src),
                                     sk.fused_table_segment_sum_bwd, sk.fused_table_segment_sum_bwd_plain, es.num_src)
    et3 = next(et for et, t in tiers.items() if t == "span")
    es3 = graph.edges[et3]
    k3 = seg_site("K3", et3, es3, es3.num_src,
                  (es3.span_src, es3.span_local, es3.span_tile_map, es3.span_base, es3.num_windows, es3.span_rows),
                  sk.span_segment_sum, sk.span_segment_sum_plain, es3.num_windows * WINDOW)
    # a planted 601-fold duplicate edge: counts stay TF32 (bf16 would make it 600)
    prng = np.random.default_rng(601)
    src = np.concatenate([np.full(601, 77), prng.integers(0, 4996, 80_000)])
    dst = np.concatenate([np.full(601, 9), prng.integers(0, 300, 80_000)])
    fwd601, rev601 = pad_edge_set(src, dst, 4996, 300, src_span_rows=256).to(dev), pad_edge_set(dst, src, 300, 4996).to(dev)
    x601 = torch.randn(4996, d, generator=gen).to(dev).to(bf)
    exact = torch.zeros(300, d, dtype=torch.float64, device=dev).index_add_(
        0, torch.from_numpy(dst).to(dev), x601.double()[torch.from_numpy(src).to(dev)])
    got = sk.span_segment_sum(x601, fwd601.span_src, fwd601.span_local, fwd601.span_tile_map, fwd601.span_base,
                              fwd601.num_windows, fwd601.span_rows)[:300]
    _compare("(b) bf16 K3 with a 601-fold edge (per-destination means vs float64)", mean_of(got, fwd601),
             exact / fwd601.dst_count.clamp_min(1.0)[:, None].double(), KERNEL_ATOL, KERNEL_RTOL)
    g601 = torch.randn(4996, d, generator=gen).to(dev).to(bf)
    exact = torch.zeros(300, d, dtype=torch.float64, device=dev).index_add_(
        0, torch.from_numpy(dst).to(dev), g601.double()[torch.from_numpy(src).to(dev)])
    got = sk.fused_table_segment_sum_bwd(g601, rev601.win_src, rev601.win_local, rev601.win_tile_map, 300)
    per = torch.bincount(torch.from_numpy(dst).to(dev), minlength=300).clamp_min(1)[:, None].double()
    _compare("(b) bf16 K2b with a 601-fold edge (per-source means vs float64)", got / per, exact / per,
             KERNEL_ATOL, KERNEL_RTOL)

    # the pair heads: K4f / K4b on the span@256 batch, K5f / K5b on the full-table batch
    def head_params():
        return [torch.randn(graph.num_nodes("patient"), 64, generator=gen).to(dev).to(bf),
                torch.randn(num_l, 64, generator=gen).to(dev).to(bf),
                (torch.randn(64, 32, generator=gen) * 0.1).to(dev).to(bf),
                (torch.randn(32, generator=gen) * 0.1).to(dev), (torch.randn(32, generator=gen) * 0.1).to(dev),
                torch.tensor([0.3], device=dev)]

    def f32(params):
        return [p.float() for p in params]

    def tile_masks(batch):
        low = (graph.patient_lab_degree[batch.patient_idx.long()] < config.model.degree_threshold).reshape(-1, TILE_E)
        return (~low).any(dim=1).to(torch.int32), low.any(dim=1).to(torch.int32)

    heads = {}
    batch = batch_cpu.to(dev)
    plan = batch.patient_plan
    gnn_mask, _ = tile_masks(batch)
    hp = head_params()
    plan_args = (batch.lab_idx, plan.win_local, plan.win_tile_map, (3, 4), gnn_mask, plan.lab_block_map, 0.2,
                 plan.lab_block_rows)
    active = int(((plan.win_local < WINDOW).reshape(-1, TILE_E) & (gnn_mask[:, None] != 0)).sum())
    got, want = pk.pair_head_fwd(*hp, *plan_args), pk.pair_head_fwd_plain(*hp, *plan_args)
    fwd_err, _ = _compare("(b) bf16 K4f (GNN head, span@256, dropout 0.2)", got, want, HEAD_ATOL, HEAD_RTOL)
    g = torch.randn(plan.win_local.shape[0], generator=gen).to(dev) * (plan.win_local < WINDOW)
    g = torch.where(pk.relu_margin_plain(*hp[:4], *plan_args) > KINK_MARGIN, g, torch.zeros_like(g))
    got = pk.pair_head_bwd(*hp, *plan_args, plan.num_windows, g)
    want = pk.pair_head_bwd_plain(*hp, *plan_args, g)
    bwd_err = max(_bf16_close(f"(b) bf16 K4b grad {n}", a.float(), b.float()) if a.dtype == bf else
                  _compare_scaled(f"(b) bf16 K4b grad {n}", a, b, GRAD_REL)
                  for n, a, b in zip(("proj_p", "proj_l", "w1", "b1", "w2", "b2"), got, want))
    head_bytes = _nbytes(*hp, *[a for a in plan_args if isinstance(a, torch.Tensor)])
    heads["pair_head_fwd"] = turns(
        "K4f GNN head", lambda: pk.pair_head_fwd(*hp, *plan_args), lambda: pk.pair_head_fwd(*f32(hp), *plan_args),
        lambda: pk.pair_head_fwd_plain(*hp, *plan_args), head_bytes + plan.win_local.shape[0] * 4,
        active * HEAD_FWD_FLOPS, fwd_err, BF16_FLOPS)
    heads["pair_head_bwd"] = turns(
        "K4b GNN head", lambda: pk.pair_head_bwd(*hp, *plan_args, plan.num_windows, g),
        lambda: pk.pair_head_bwd(*f32(hp), *plan_args, plan.num_windows, g),
        lambda: pk.pair_head_bwd_plain(*hp, *plan_args, g), head_bytes + _nbytes(g, *want),
        active * HEAD_BWD_FLOPS, bwd_err, BF16_FLOPS)
    batch0 = masker0.get_split("train").to(dev)
    plan0 = batch0.patient_plan
    masks0 = tile_masks(batch0)
    dp = head_params() + head_params()
    dual_args = (batch0.lab_idx, plan0.win_local, plan0.win_tile_map, (1, 2, 3, 4), masks0[1], masks0[0], 0.2)
    got, want = pk.pair_head_dual_fwd(*dp, *dual_args), pk.pair_head_dual_fwd_plain(*dp, *dual_args)
    fwd_err = max(_compare(f"(b) bf16 K5f {h}", a, b, HEAD_ATOL, HEAD_RTOL)[0] for h, a, b in zip(("tab", "gnn"), got, want))
    margins = pk.relu_margin_dual_plain(*dp[0:4], *dp[6:10], *dual_args)
    gs = [torch.where(m > KINK_MARGIN, torch.randn(m.shape[0], generator=gen).to(dev), torch.zeros_like(m))
          * (plan0.win_local < WINDOW) for m in margins]
    got = pk.pair_head_dual_bwd(*dp, *dual_args, plan0.num_windows, *gs)
    want = pk.pair_head_dual_bwd_plain(*dp, *dual_args, *gs)
    names = [f"{h}.{n}" for h in ("tab", "gnn") for n in ("proj_p", "proj_l", "w1", "b1", "w2", "b2")]
    bwd_err = max(_bf16_close(f"(b) bf16 K5b grad {n}", a.float(), b.float()) if a.dtype == bf else
                  _compare_scaled(f"(b) bf16 K5b grad {n}", a, b, GRAD_REL) for n, a, b in zip(names, got, want))
    active0 = sum(int(((plan0.win_local < WINDOW).reshape(-1, TILE_E) & (m[:, None] != 0)).sum()) for m in masks0)
    dual_bytes = _nbytes(*dp, *[a for a in dual_args if isinstance(a, torch.Tensor)])
    heads["pair_head_dual_fwd"] = turns(
        "K5f both heads", lambda: pk.pair_head_dual_fwd(*dp, *dual_args), lambda: pk.pair_head_dual_fwd(*f32(dp), *dual_args),
        lambda: pk.pair_head_dual_fwd_plain(*dp, *dual_args), dual_bytes + 2 * plan0.win_local.shape[0] * 4,
        active0 * HEAD_FWD_FLOPS, fwd_err, BF16_FLOPS)
    heads["pair_head_dual_bwd"] = turns(
        "K5b both heads", lambda: pk.pair_head_dual_bwd(*dp, *dual_args, plan0.num_windows, *gs),
        lambda: pk.pair_head_dual_bwd(*f32(dp), *dual_args, plan0.num_windows, *gs),
        lambda: pk.pair_head_dual_bwd_plain(*dp, *dual_args, *gs), dual_bytes + _nbytes(*gs, *want),
        active0 * HEAD_BWD_FLOPS, bwd_err, BF16_FLOPS)
    big = lambda sites: sites[next(iter(sites))]  # noqa: E731 (the largest relation)
    out["kernels"] = {
        "segment_sum_windowed": {**big(k1_sites), "call_sites": k1_sites},
        "fused_table_segment_sum": {**big(k2f), "relations": k2f},
        "fused_table_segment_sum_bwd": {**big(k2b), "relations": k2b},
        "span_segment_sum": k3, **heads,
    }
    del hp, dp, gs, got, want, batch, batch0, state, fn, model_gpu, trainer
    torch.cuda.empty_cache()

    # (e) speed: RGCN and HGT epochs, bf16 and float32 in turns (dropout 0.2)
    def epochs_in_turns(cfgs, g, m, n):
        trainers = {}
        for key, cfg in cfgs.items():
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            model = build_model(cfg, graph_cpu, generator=torch.Generator().manual_seed(1))
            tr = Trainer(model, g, m, cfg)
            tr.train_epoch()
            tr.epoch += 1
            torch.cuda.synchronize()
            trainers[key] = (tr, torch.cuda.max_memory_allocated() - base)
        ms = {key: [] for key in cfgs}
        for i in range(n):
            for key in (list(cfgs) if i % 2 == 0 else list(cfgs)[::-1]):
                tr = trainers[key][0]
                t_ep = time.perf_counter()
                tr.train_epoch()
                torch.cuda.synchronize()
                ms[key].append((time.perf_counter() - t_ep) * 1e3)
                tr.epoch += 1
        result = {}
        for key, (tr, peak) in trainers.items():
            wall, busy, top = _device_profile(tr.train_epoch)
            val = tr.validate("val")
            if not np.isfinite(val):
                raise AssertionError(f"(e) {key}: non-finite validation loss")
            result[key] = {"epoch_ms": statistics.median(ms[key]), "epochs_ms": ms[key], "wall_ms": wall,
                           "device_ms": busy, "idle": max(0.0, 1 - busy / wall), "peak_gib": peak / 2**30,
                           "val_loss": val, "top": top[:6]}
            print(f"    (e) {key}: epochs {['%.2f' % x for x in ms[key]]} ms (median {result[key]['epoch_ms']:.2f}); "
                  f"profiled epoch wall {wall:.2f} ms, device {busy:.2f} ms, idle share {result[key]['idle']:.4f}; "
                  f"peak above the graph {peak / 2**30:.3f} GiB; val loss {val:.6f}", flush=True)
            for name, t in top[:6]:
                print(f"          {t:8.3f} ms  {name[:110]}")
        del trainers
        torch.cuda.empty_cache()
        return result

    out["rgcn"] = epochs_in_turns({"RGCN bf16": with_dtype(config, "bfloat16"), "RGCN f32": config},
                                  graph, masker, BF16_RGCN_EPOCHS)
    out["hgt"] = epochs_in_turns({"HGT bf16": with_dtype(hgt_config, "bfloat16"), "HGT f32": hgt_config},
                                 graph_hgt, masker, BF16_HGT_EPOCHS)
    # phase 3's graph is the bench's (scale_100k, no dense tier, span 256): not built again
    line = bench.run_bench(scale=True, dense=False, quick=True, bf16=True, graph=graph)
    print("    (e) bench --scale --no-dense --quick --bf16: " + json.dumps(line), flush=True)
    if line["compute_dtype"] != "bfloat16" or not line["value"] > 0 or "mxu_bf16_speedup" not in line:
        raise AssertionError(f"bench --bf16: {line}")
    out["bench"] = line

    # (f) quality: JAX's bfloat16 pin (tests/test_mxu_probe.py:132-172) with
    # the port on the card, beside float32; the flagship seed 42 in bfloat16
    pin = {}
    spec = dataclasses.replace(SyntheticSpec.eicu_demo(), seed=0, signal_strength=0.6)
    tables = generate_synthetic_tables(spec)
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(config.__class__(), model=dataclasses.replace(
            config.__class__().model, compute_dtype=dtype, edge_head=dataclasses.replace(
                config.__class__().model.edge_head, extras={"bilinear_rank": 9, "bilinear_source": "embedding"})),
            train=dataclasses.replace(config.__class__().train, loss="mse"))
        bundle = build_heterogeneous_graph(tables["labs_normalized"], tables["diagnoses"], tables["medications"],
                                           tables["cohort"], tables["labitems"], cfg)
        pm = EdgeMasker(bundle.graph, seed=42)
        tr = Trainer(build_model(cfg, bundle.graph, generator=torch.Generator().manual_seed(
            stream_seed(cfg.train.seed, "init"))), bundle.graph, pm, cfg)
        warm_start_trainer(tr, rank=8, reg=12.0)
        _, _, te_v = pm.split_arrays("test")
        pin[dtype] = compute_regression_metrics(tr.predict("test").astype(np.float64), te_v)["r2"]
    print(f"    (f) JAX's bf16 quality pin on the card: test R2 bf16 {pin['bfloat16']:.6f} (>= {BF16_PIN_R2_MIN}), "
          f"float32 {pin['float32']:.6f}", flush=True)
    if not pin["bfloat16"] >= BF16_PIN_R2_MIN:
        raise AssertionError(f"bf16 quality pin: R2 {pin['bfloat16']:.4f} < {BF16_PIN_R2_MIN}")
    # the flagship in bfloat16 went through the command line (steps 1-8)
    # beside phase 21's float32 runs
    flag, flag_s = flag_run, flag_run["step_seconds"]
    if flag["missing"]:
        raise AssertionError(f"the bf16 flagship run left out {flag['missing']}")
    # step 8's bf16 artifact served on the card, as phase 21 serves float32's
    served = _flagship_serving_check(flag_dir, dev)
    print(f"    (f) conf/eicu_real.yaml, compute_dtype bfloat16, seed {FLAGSHIP_SEEDS[0]}: steps "
          + ", ".join(f"{k} {v:.2f} s" for k, v in flag_s.items())
          + f"; {flag['epochs']} epochs; guarded R2 {flag['r2']:.6f}, MAE {flag['mae']:.6f} (phase 21's "
          f"float32 seed {FLAGSHIP_SEEDS[0]}: {flagship_r2_f32:.6f}; the JAX package's bf16 run, CPU: "
          f"{JAX_CPU_BF16_R2_42:.6f})", flush=True)
    print(f"    (f) the bf16 step-8 artifact: {served}", flush=True)
    if flag["leak"] or not abs(flag["r2"] - flagship_r2_f32) <= BF16_NOISE_BUDGET:
        raise AssertionError(f"bf16 flagship: R2 {flag['r2']:.6f} not within {BF16_NOISE_BUDGET} of phase 21's "
                             f"float32 {flagship_r2_f32:.6f}, or the audit reports a leak")
    out["quality"] = {"pin": pin, "flagship_r2": flag["r2"], "flagship_mae": flag["mae"]}
    return out


def _bits_equal(got, want) -> bool:
    import numpy as np

    return all(
        g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g.view(np.uint8), w.view(np.uint8))
        for g, w in zip(got, want)
    )


def _graph_arrays_equal(a, b) -> list:
    """The names of the plan arrays that differ between two graphs (every
    tensor and count of every edge set, and the degree vector)."""
    import torch

    bad = []
    if not torch.equal(a.patient_lab_degree, b.patient_lab_degree):
        bad.append("patient_lab_degree")
    for et, es in a.edges.items():
        other = b.edges[et]
        for f in dataclasses.fields(es):
            x, y = getattr(es, f.name), getattr(other, f.name)
            same = (x is None and y is None) or (
                torch.equal(x, y) if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) else x == y
            )
            if not same:
                bad.append(f"{'/'.join(et)}.{f.name}")
    return bad


def _ingest_phase(dev, reset_counts, counts_of) -> dict:
    """Phase 28: raw MIMIC-III-shaped CSVs through the graph core's scan,
    preprocess and the graph build into kernel epochs on the card; the
    scan and the plans against their plain versions; a raw eICU directory
    through the command line."""
    import gzip
    import subprocess

    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch import native
    from multi_modal_gnn_tpu_torch.config import save_config
    from multi_modal_gnn_tpu_torch.graph.build import build_graph_from_preprocessed
    from multi_modal_gnn_tpu_torch.graph.schema import mirror_edge_type
    from multi_modal_gnn_tpu_torch.ops import _build, aggregation_tier
    from multi_modal_gnn_tpu_torch.tools import bench_etl

    out = {}
    root = Path(tempfile.mkdtemp(prefix="mmgnn_etl_"))
    try:
        # (a) the raw directory
        raw = root / "raw"
        emitted = bench_etl.emit_raw_mimic(raw, ETL_PATIENTS, ETL_LAB_ROWS, ETL_LABS, ETL_DX, ETL_RX, seed=0)
        out["emit_s"] = emitted["emit_s"]
        print(f"    (a) raw MIMIC-III CSVs: {ETL_PATIENTS} patients, {ETL_LAB_ROWS} LABEVENTS rows, {ETL_LABS} labs, "
              f"written in {emitted['emit_s']:.2f} s", flush=True)

        # (b) the scan: native against plain on the first rows, plain and gzip
        t_build = time.perf_counter()
        library = _build.build_graphcore()
        native.load()
        print(f"    (b) graph core {library.name}, "
              f"ready in {time.perf_counter() - t_build:.2f} s; {_build.graphcore_log.splitlines()[0] if _build.graphcore_log else 'built before'}")
        small = root / "scan"
        small.mkdir()
        with open(raw / "LABEVENTS.csv") as f:
            text = "".join(f.readline() for _ in range(ETL_SCAN_ROWS + 1))
        (small / "LABEVENTS.csv").write_text(text)
        with gzip.open(small / "LABEVENTS.csv.gz", "wt") as f:
            f.write(text)
        ids = np.arange(10_000, 10_000 + ETL_PATIENTS, 2, dtype=np.int64)  # every other patient
        # the plain version once, on the plain file: both files hold the same text
        t0 = time.perf_counter()
        want = native.labevents_scan_plain(small / "LABEVENTS.csv", 0, 1, 3, 2, ids)
        scans = {"plain_s": time.perf_counter() - t0}
        for name in ("LABEVENTS.csv", "LABEVENTS.csv.gz"):
            before = native.launch_counts["labevents_scan"]
            t0 = time.perf_counter()
            got = native.labevents_scan(small / name, 0, 1, 3, 2, ids)
            t_native = time.perf_counter() - t0
            if native.launch_counts["labevents_scan"] != before + 1:
                raise AssertionError("(b) the scan did not take the native route")
            if not _bits_equal(got, want) or len(got[0]) < ETL_SCAN_ROWS // 3:
                raise AssertionError(f"(b) {name}: the native scan ({len(got[0])} rows) differs from its plain "
                                     f"version ({len(want[0])} rows)")
            scans[name] = {"rows_kept": len(got[0]), "native_s": t_native}
            print(f"    (b) {name} ({ETL_SCAN_ROWS} rows): native {t_native:.3f} s, plain (on the .csv) "
                  f"{scans['plain_s']:.3f} s, {len(got[0])} rows kept, arrays bit-equal")
        out["scan_check"] = scans

        # the full scan, preprocess and the graph build (the core)
        config = bench_etl.etl_config(raw, root / "interim", root / "out")
        stages, bundle = bench_etl.ingest(config, lab_rows=ETL_LAB_ROWS)
        out["stages"] = stages
        if stages["labevents_scan"]["native"] != 1:
            raise AssertionError(f"the full scan did not take the native route: {stages['labevents_scan']}")
        calls = stages["graph_build"]["native_calls"]
        if not all(calls[k] for k in ("sort_edges_by_dst", "factorize", "window_plan", "span_plan")):
            raise AssertionError(f"(c) the graph build did not run every plan in the core: {calls}")

        # (c) the plain plans against the core's (the build above)
        reset_native = dict(native.launch_counts)
        with native.plain_route():
            t0 = time.perf_counter()
            plain = build_graph_from_preprocessed(config.data.interim_dir, config)
            t_plain = time.perf_counter() - t0
        if native.launch_counts != reset_native:
            raise AssertionError("(c) the plain build called the core")
        bad = _graph_arrays_equal(bundle.graph, plain.graph)
        if bad:
            raise AssertionError(f"(c) the plain graph differs from the core's: {bad}")
        out["graph_build_s"] = {"core": stages["graph_build"]["s"], "plain": t_plain}
        print(f"    (c) graph build: core {stages['graph_build']['s']:.3f} s, plain {t_plain:.3f} s; "
              f"every plan array equal")
        del plain

        # (d) training on the card: the tiers' kernels launch, losses finite
        g = bundle.graph
        d = config.model.hidden_dim
        tiers = {et: aggregation_tier(es, g.edges.get(mirror_edge_type(et)), d) for et, es in g.edges.items()}
        print("    (d) tiers: " + ", ".join(f"{'/'.join(et)} {t}" for et, t in tiers.items()))
        expected = set()
        for t in tiers.values():
            expected |= {"fused_table": {"fused_table_segment_sum", "fused_table_segment_sum_bwd"},
                         "span": {"span_segment_sum", "segment_sum_windowed"},
                         "paired": {"segment_sum_windowed"}, "windowed": {"segment_sum_windowed"}}.get(t, set())
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        line, trainer = bench_etl.train(config, bundle, dev, epochs=ETL_EPOCHS)
        launches = counts_of()
        plan = trainer.get_batch("train").patient_plan
        if not (plan is not None and plan.identity and trainer.model.head_style == "factored"):
            raise AssertionError("(d) the ETL train batch is not slot-major with factored heads: no pair-head kernel")
        expected |= {"pair_head_fwd", "pair_head_bwd"}
        missing = sorted(k for k in expected if not launches.get(k))
        if missing:
            raise AssertionError(f"(d) kernels of the tiers did not launch in the ETL epochs: {missing} ({launches})")
        metrics = (line["test_r2"], line["test_mae"])
        if not all(np.isfinite(line["losses"])) or not all(np.isfinite(metrics)):
            raise AssertionError(f"(d) non-finite losses or metrics: {line['losses']}, {metrics}")
        out["train"] = {**line, "launches": launches, "expected": sorted(expected)}
        print(f"    (d) {ETL_EPOCHS} epochs: first {line['first_epoch_s']:.3f} s, then "
              f"{', '.join('%.4f' % x for x in line['epoch_s'])} s; losses {line['losses']}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; test R2 {metrics[0]:.4f}, MAE {metrics[1]:.4f}")
        del trainer, bundle
        gc.collect()
        torch.cuda.empty_cache()

        # (e) a raw eICU directory through the command line, on the card
        eraw = bench_etl.emit_raw_eicu(root / "eicu_raw", num_stays=ETL_EICU_STAYS)
        ecfg = save_config(bench_etl.eicu_config(eraw, root / "eicu"), root / "eicu.yaml")
        command = [sys.executable, "-m", "multi_modal_gnn_tpu_torch", "--config", str(ecfg), "--step", "1-4",
                   "--no-confirm"]
        t0 = time.perf_counter()
        proc = subprocess.run(command, cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"(e) {' '.join(command)} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        steps = json.loads(proc.stdout.strip().splitlines()[-1])["step_seconds"]
        with open(root / "eicu" / "out" / "evaluation_results.json") as f:
            overall = json.load(f)["overall_metrics"]
        if not all(np.isfinite([overall["r2"], overall["mae"]])):
            raise AssertionError(f"(e) non-finite eICU metrics: {overall}")
        out["eicu"] = {"s": time.perf_counter() - t0, "step_seconds": steps, "r2": overall["r2"],
                       "mae": overall["mae"]}
        print(f"    (e) eICU ({ETL_EICU_STAYS} stays) through python -m multi_modal_gnn_tpu_torch --step 1-4: "
              f"{time.perf_counter() - t0:.2f} s, steps {steps}, test R2 {overall['r2']:.4f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _calibration_close(label: str, got: list, want: list) -> float:
    """Two per-lab calibration tables (rows keyed by lab) within
    VIZ_ATOL; the largest difference, scaled as the bound is."""
    if sorted(r["lab_index"] for r in got) != sorted(r["lab_index"] for r in want):
        raise AssertionError(f"{label}: the calibration tables hold other labs")
    by_lab = {r["lab_index"]: r for r in got}
    worst = 0.0
    for ref in want:
        row = by_lab[ref["lab_index"]]
        if row["num_samples"] != ref["num_samples"]:
            raise AssertionError(f"{label}: lab {ref['lab_index']}: {row['num_samples']} rows, not {ref['num_samples']}")
        for col in ("slope", "intercept", "mae", "mae_recalibrated", "mae_delta"):
            bound = VIZ_ATOL * (1.0 + abs(ref[col]))
            if col in ("mae_recalibrated", "mae_delta"):
                bound /= min(1.0, abs(ref["slope"]))
            diff = abs(float(row[col]) - ref[col])
            worst = max(worst, diff / bound)
            if not diff <= bound:
                raise AssertionError(f"{label}: lab {ref['lab_index']} {col} {row[col]} against {ref[col]} "
                                     f"(bound {bound:.3e})")
    return worst


def _plane_close(label: str, got, want) -> float:
    """Two PCA projections, each component up to its sign, within VIZ_ATOL;
    the largest difference."""
    worst = 0.0
    for comp in range(2):
        sign = 1.0 if float((got[:, comp] * want[:, comp]).sum()) >= 0 else -1.0
        worst = max(worst, float((sign * got[:, comp] - want[:, comp]).abs().max()))
    if not worst <= VIZ_ATOL:
        raise AssertionError(f"{label}: the PCA planes differ by {worst:.3e} > {VIZ_ATOL}")
    return worst


def _read_calibration(path: Path) -> list:
    import csv

    with open(path) as f:
        return [
            {k: (int(v) if k in ("lab_index", "num_samples") else v if k == "lab_name" else float(v))
             for k, v in row.items()}
            for row in csv.DictReader(f)
        ]


def _visualize_phase(dev, life_dir, life_config, hgt_state, hgt_config, graph_cpu, graph, graph_hgt, graph_seg,
                     masker, config, reset_counts, counts_of) -> dict:
    """Phase 29: the pipeline's visualize step (step 6) on phase 20's RGCN
    run and phase 14's HGT on the card, against the CPU plain path and the
    segment tier; the Bayes and LMMSE ceilings on the card against the CPU
    and the JAX package; tools/diagnose_quality on the card against its CPU
    yardsticks."""
    import subprocess

    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch import viz
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec
    from multi_modal_gnn_tpu_torch.evaluation import gaussian_conditional_ceiling
    from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta
    from multi_modal_gnn_tpu_torch.graph.schema import PATIENT
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.ops import attention_kernels as ak
    from multi_modal_gnn_tpu_torch.tools import diagnose_quality
    from multi_modal_gnn_tpu_torch.training import Trainer, masker_from_config
    from multi_modal_gnn_tpu_torch.utils.io import load_json
    from multi_modal_gnn_tpu_torch.viz.advanced import per_lab_calibration

    out = {}
    repo = Path(__file__).resolve().parent
    drawing = viz.library_available("matplotlib")
    tmp = Path(tempfile.mkdtemp(prefix="mmgnn_viz_"))
    # (d) first, in the background: the card's run trains while (a)-(c) run
    module = "multi_modal_gnn_tpu_torch.tools.diagnose_quality"
    commands = {
        "card": [sys.executable, "-m", module, "--spec", "eicu", "--epochs", str(DIAGNOSE_EPOCHS),
                 "--out-dir", str(tmp / "dq"), "--tag", "card"],
        "cpu": [sys.executable, "-m", module, "--spec", "eicu", "--skip-train", "--device", "cpu",
                "--out-dir", str(tmp / "dq"), "--tag", "cpu"],
    }
    t_dq = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, c in commands.items()}
    try:
        def check_figures(label, summary, run_dir):
            left_out = summary["left_out"]
            if drawing:
                missing = [p for p in summary["drawn"] if not Path(p).exists()]
                if missing or not summary["drawn"]:
                    raise AssertionError(f"({label}) figures not written: {missing or 'none drawn'}")
            elif summary["drawn"] or set(left_out.values()) != {"matplotlib is not installed"}:
                raise AssertionError(f"({label}) without matplotlib: drew {summary['drawn']}, left out {left_out}")
            if [Path(p).name for p in summary["written"]] != ["per_lab_calibration.csv"]:
                raise AssertionError(f"({label}) wrote {summary['written']}")
            return sorted(Path(p).name for p in left_out)

        # (a) step 6 on phase 20's run, the trainer restored from its best
        # checkpoint as the pipeline's step restores it
        model = build_model(life_config, graph_cpu, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, graph, masker_from_config(life_config, graph), life_config)
        trainer.restore(life_dir / "best_model.ckpt")
        trainer.best_state = copy.deepcopy(trainer.model.state_dict())
        bundle = GraphBundle(graph=graph, meta=GraphMeta())
        history = load_json(life_dir / "training_history.json")
        torch.cuda.synchronize()
        reset_counts()
        t_step = time.perf_counter()
        summary = viz.visualize(life_config, bundle, trainer, history=history, output_dir=life_dir)
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t_step
        launches = counts_of()
        out["launches"] = launches
        for name in ("segment_sum_windowed", "fused_table_segment_sum", "span_segment_sum"):
            if not launches[name]:
                raise AssertionError(f"(a) {name} did not launch in step 6: {launches}")
        left_out = check_figures("a", summary, life_dir)
        print(f"    (a) step 6 on phase 20's run (RGCN, scale_100k): {out['step_s']:.2f} s; launches "
              f"{ {k: v for k, v in launches.items() if v} }; matplotlib {'present' if drawing else 'absent'}: "
              f"drew {len(summary['drawn'])}, left out {len(left_out)} {left_out}, for "
              f"{sorted(set(summary['left_out'].values()))}", flush=True)
        rows = _read_calibration(life_dir / "advanced_visualizations" / "per_lab_calibration.csv")
        card_plane = viz.pca_2d(torch.cat(list(viz.node_embeddings(trainer).values())))
        card_preds = trainer.predict("test", state=trainer.best_state)
        # the CPU plain path: the same best state, the plain versions
        cpu_model = build_model(life_config, graph_cpu, generator=torch.Generator().manual_seed(0))
        cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.best_state.items()})
        cpu = Trainer(cpu_model, graph_cpu, masker_from_config(life_config, graph_cpu), life_config, device="cpu")
        t_cpu = time.perf_counter()
        cpu_preds = cpu.predict("test")
        cpu_s = time.perf_counter() - t_cpu
        _, test_l, test_v = trainer.masker.split_arrays("test")
        worst = _calibration_close("(a) per_lab_calibration.csv, card against the CPU plain path",
                                   rows, per_lab_calibration(cpu_preds, test_v, test_l, {}))
        cpu_plane = viz.pca_2d(torch.cat(list(viz.node_embeddings(cpu).values())))
        plane_err = _plane_close("(a) embeddings", card_plane.cpu(), cpu_plane)
        print(f"    (a) {len(rows)} calibration rows within {worst:.3f} of the bound of the CPU plain path's "
              f"(its test predictions {cpu_s:.2f} s; card - CPU max |d| {np.abs(card_preds - cpu_preds).max():.3e}); "
              f"the PCA plane of {card_plane.shape[0]} embeddings within {plane_err:.3e} of the CPU's", flush=True)
        out["a"] = {"rows": len(rows), "calibration": worst, "plane": plane_err, "left_out": left_out}
        del trainer, model, cpu, cpu_model

        # (b) the HGT of phase 14 on its flash tier, against the segment tier
        hgt_seg_config = dataclasses.replace(
            hgt_config, model=dataclasses.replace(hgt_config.model, extras={"hgt_flash": "off"}))
        hgt = {}
        for tier, cfg, g in (("flash", hgt_config, graph_hgt), ("segment", hgt_seg_config, graph_seg)):
            model = build_model(cfg, graph_cpu, generator=torch.Generator().manual_seed(0))
            model.load_state_dict(hgt_state)
            tr = Trainer(model, g, masker, cfg)
            torch.cuda.synchronize()
            reset_counts()
            t_step = time.perf_counter()
            summary = viz.visualize(cfg, GraphBundle(graph=g, meta=GraphMeta()), tr, output_dir=tmp / tier)
            torch.cuda.synchronize()
            hgt[tier] = {
                "s": time.perf_counter() - t_step, "launches": dict(ak.launch_counts),
                "rows": _read_calibration(tmp / tier / "advanced_visualizations" / "per_lab_calibration.csv"),
                "plane": viz.pca_2d(torch.cat(list(viz.node_embeddings(tr).values()))),
                "left_out": check_figures(f"b, {tier}", summary, tmp / tier),
            }
            del model, tr
        flash, seg = hgt["flash"], hgt["segment"]
        if not flash["launches"]["flash_attention_fwd"] or any(seg["launches"].values()):
            raise AssertionError(f"(b) launches: flash tier {flash['launches']}, segment tier {seg['launches']}")
        h_worst = _calibration_close("(b) the HGT's calibration table, flash against segment tier",
                                     flash["rows"], seg["rows"])
        h_plane = _plane_close("(b) the HGT's embeddings", flash["plane"], seg["plane"])
        out["launches_hgt"] = flash["launches"]
        print(f"    (b) step 6 on the HGT: flash tier {flash['s']:.2f} s (launches {flash['launches']}), segment tier "
              f"{seg['s']:.2f} s; calibration within {h_worst:.3f} of the bound, PCA plane within {h_plane:.3e}; "
              f"left out {len(flash['left_out'])}", flush=True)

        # (c) the flat Bayes ceiling of phase 3's cohort on its train / test
        # split, card against CPU; the LMMSE ceiling of the flagship's cohort
        w, signal = diagnose_quality.flat_graph_loadings(SyntheticSpec.scale_100k(seed=0), config)
        train, test = masker.split_arrays("train"), masker.split_arrays("test")
        num_p = graph.num_nodes(PATIENT)
        ceil = {}
        for where in ("card", "cpu"):
            device = dev if where == "card" else torch.device("cpu")
            if where == "card":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t_c = time.perf_counter()
            ceil[where] = gaussian_conditional_ceiling(w, signal, *train, *test, num_patients=num_p, device=device)
            if where == "card":
                torch.cuda.synchronize()
                ceil["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            ceil[where + "_s"] = time.perf_counter() - t_c
        got, want = ceil["card"], ceil["cpu"]
        pairs = [(f"expected {k}", got["expected"][k], want["expected"][k]) for k in want["expected"]]
        pairs += [(f"realized {k}", got["realized"][k], want["realized"][k]) for k in want["realized"]]
        pairs.append(("mean_posterior_var", got["mean_posterior_var"], want["mean_posterior_var"]))
        rel = max(abs(a - b) / abs(b) for _, a, b in pairs)
        pred_rel = float(np.abs(got["predictions"] - want["predictions"]).max() / np.abs(want["predictions"]).max())
        if not (rel <= CEILING_REL and pred_rel <= CEILING_REL):
            raise AssertionError(f"(c) the flat ceiling on the card differs from the CPU's: {pairs}, "
                                 f"predictions {pred_rel:.3e}")
        lmmse = diagnose_quality.eicu_lmmse_ceiling(SyntheticSpec.eicu_real(0), device=dev)
        l_rel = max(abs(lmmse[k] - JAX_CPU_LMMSE[k]) / abs(JAX_CPU_LMMSE[k]) for k in JAX_CPU_LMMSE)
        if not l_rel <= CEILING_REL:
            raise AssertionError(f"(c) the LMMSE ceiling {lmmse} differs from the JAX package's {JAX_CPU_LMMSE}")
        band = JAX_CPU_BAND["r2"]
        print(f"    (c) the Bayes ceiling of scale_100k ({len(train[0])} train edges observed, {len(test[0])} test "
              f"queried): expected R2 {got['expected']['r2']:.6f}, realized R2 {got['realized']['r2']:.6f}; card "
              f"{ceil['card_s']:.3f} s, peak {ceil['peak_gib']:.3f} GiB, CPU {ceil['cpu_s']:.3f} s; card against CPU "
              f"within {rel:.2e} (predictions {pred_rel:.2e}); the LMMSE ceiling of conf/eicu_real.yaml's cohort "
              f"R2 {lmmse['r2']:.6f} (the JAX package's {JAX_CPU_LMMSE['r2']:.6f}, within {l_rel:.2e}) beside "
              f"phase 21's JAX CPU R2 band [{min(band):.4f}, {max(band):.4f}]", flush=True)
        out["ceiling"] = {"card_s": ceil["card_s"], "cpu_s": ceil["cpu_s"], "peak_gib": ceil["peak_gib"],
                          "rel": rel, "expected_r2": got["expected"]["r2"], "realized_r2": got["realized"]["r2"],
                          "lmmse_r2": lmmse["r2"]}

        # (d) tools/diagnose_quality: the card's yardsticks equal the CPU's
        reports = {}
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"(d) {' '.join(commands[key])} exited {proc.returncode}:\n{stderr[-3000:]}")
            reports[key] = json.loads(stdout.strip().splitlines()[-1])
        dq_s = time.perf_counter() - t_dq
        card, cpu_r = reports["card"], reports["cpu"]
        pairs = [(f"ceiling {k} {m}", card["ceiling"][k][m], cpu_r["ceiling"][k][m])
                 for k in ("expected", "realized") for m in cpu_r["ceiling"][k]]
        pairs += [(f"combined {m}", card["combined_ceiling"]["realized"][m], cpu_r["combined_ceiling"]["realized"][m])
                  for m in cpu_r["combined_ceiling"]["realized"]]
        pairs += [(f"als {m}", card["als"][m], cpu_r["als"][m]) for m in cpu_r["als"]]
        dq_rel = max(abs(a - b) / abs(b) for _, a, b in pairs)
        if not (dq_rel <= CEILING_REL and card["combined_ceiling"]["reg"] == cpu_r["combined_ceiling"]["reg"]):
            raise AssertionError(f"(d) the card's yardsticks differ from the CPU's: {pairs}")
        model_m = card.get("model")
        if model_m is None or not all(math.isfinite(v) for v in model_m["raw"].values()):
            raise AssertionError(f"(d) the card's training gave no finite test metrics: {card.get('train_error')}")
        print(f"    (d) diagnose_quality --spec eicu --epochs {DIAGNOSE_EPOCHS} on the card beside its --device cpu "
              f"--skip-train run ({dq_s:.1f} s wall, both in the background of (a)-(c)): yardsticks within "
              f"{dq_rel:.2e}; ceiling realized R2 {card['ceiling']['realized']['r2']:.6f}, combined "
              f"{card['combined_ceiling']['realized']['r2']:.6f}, ALS {card['als']['r2']:.6f}; the GNN "
              f"{model_m['epochs_run']} epochs in {model_m['train_time_s']:.2f} s: test R2 {model_m['raw']['r2']:.6f}, "
              f"winsorized {model_m['winsorized']['r2']:.6f}", flush=True)
        out["diagnose"] = {"rel": dq_rel, "s": dq_s, "model_r2": model_m["raw"]["r2"]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    import numpy as np
    import torch

    from multi_modal_gnn_tpu_torch import native
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
    t_core = time.perf_counter()
    native.load()  # the host graph core (csrc/graphcore.cpp, g++): a failed build raises
    core_s = time.perf_counter() - t_core
    print(f"    graph core: {_build.build_graphcore().name}, "
          f"{core_s:.2f} s" + (f" ({_build.graphcore_log.splitlines()[0]})" if _build.graphcore_log else ""))
    _phase("build", t0, f"built and loaded {_build.build().name} from {len(_build.SOURCES)} sources and the graph core")

    # 3. graph -------------------------------------------------------------
    t0 = time.perf_counter()
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0, src_span_rows=256),
        model=ModelConfig(use_pallas=True),
    )
    d = config.model.hidden_dim
    native.reset_launch_counts()
    graph_cpu = make_synthetic_graph(SyntheticSpec.scale_100k(seed=0), config, device="cpu")
    core_calls = dict(native.launch_counts)
    if not all(core_calls[k] for k in ("sort_edges_by_dst", "window_plan", "span_plan")):
        raise AssertionError(f"the graph build did not run its plans in the graph core: {core_calls}")
    print(f"    graph core calls: {core_calls}")
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
    # K1 on tiles of unsorted runs cut at chunk boundaries (a span-mode train
    # batch's patient plan, the backward of take_rows), from pre-gathered
    # rows and from the 100,000-row patient table, at the context bilinear
    # source's width and at d
    cut_local, cut_map, cut_windows = _cut_run_plan(256, seed=0)
    cut = (cut_local.to(dev), cut_map.to(dev), cut_windows)
    n_patients = graph.num_nodes(PATIENT)
    for w in (VC_RANK, d):
        rows_w = torch.randn(cut_local.shape[0], w, generator=gen).to(dev)
        table_w = torch.randn(n_patients, w, generator=gen).to(dev)
        idx_w = torch.randint(0, n_patients, (cut_local.shape[0],), generator=gen, dtype=torch.int32).to(dev)
        for route, src, idx in (("gathered", rows_w, None), ("global", table_w, idx_w)):
            _compare_scaled(f"segment_sum_windowed on unsorted tiles with cut runs, D {w}, {route} rows",
                            sk.segment_sum_windowed(src, idx, *cut), sk.segment_sum_windowed_plain(src, idx, *cut),
                            1e-4)

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
    rgcn_train = (statistics.median(epoch_ms), edges_per_s)  # phase 23 prints them beside its own
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

    hgt_state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}  # phase 29's HGT
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
    tool = {dtype: bench_gather.main(["--dtype", dtype]) for dtype in ("float32", "bfloat16")}  # the script's defaults
    probe_launches = dict(gp.launch_counts)  # the probe's path ends here
    if not all(probe_launches.values()):
        raise AssertionError(f"a kernel of the gather probe did not launch: {probe_launches}")
    probe_results = {}
    for dtype in ("float32", "bfloat16"):
        suffix = "_bf16" if dtype == "bfloat16" else ""
        for h in (64, 128):
            args = bench_gather.parse_args(["--h", str(h), "--dtype", dtype])
            idx, table, padded = bench_gather.to_device(args, bench_gather.make_inputs(args), dev)
            n_slots = idx.shape[0]
            # kernel, its table, library call, FLOPs of the function (each slot's
            # row sum); A's one-hot product does rows times that work, reported
            # apart as onehot_ops_ms (at the table dtype's peak) and not used as
            # its bound
            work = {
                "gather_probe_indicator": (
                    lambda: gp.gather_probe_indicator(idx, table), table,
                    lambda: torch.index_select(table, 0, idx).sum(1, dtype=torch.float32), float(n_slots * h),
                ),
                "gather_probe_padded": (
                    lambda: gp.gather_probe_padded(idx, padded, h), padded,
                    lambda: torch.index_select(padded, 0, idx)[:, :h].sum(1, dtype=torch.float32),
                    float(n_slots * h),
                ),
                "gather_probe_direct": (
                    lambda: gp.gather_probe_direct(idx, table), table,
                    lambda: torch.index_select(table, 0, idx).sum(1, dtype=torch.float32), float(n_slots * h),
                ),
            }
            for name, (kernel, tbl, library, flops) in work.items():
                plain = lambda tbl=tbl: gp.gather_rowsum_plain(idx, tbl, h)  # noqa: E731
                err = _compare_scaled(f"{name} ({dtype}), H {h}", kernel(), plain(), 1e-5)
                ms, plain_ms = _median_ms(kernel), _median_ms(plain)
                bound = _bound(_nbytes(idx, tbl) + n_slots * 4, flops)
                if name == "gather_probe_indicator":
                    peak = BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS
                    bound["onehot_ops_ms"] = 2.0 * n_slots * args.rows * h / peak * 1e3
                    layout = f"  one-hot product's operations {bound['onehot_ops_ms']:.4f} ms"
                else:
                    staged = gp.direct_staged(*tbl.shape, tbl.dtype)
                    layout = "  table in shared memory" if staged else "  table through L2"
                print(
                    f"    {name} ({dtype}), H {h}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                    f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}){layout}"
                )
                probe_results.setdefault(name + suffix, {})[h] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
                    "library_ms": _library_ms(f"{name} ({dtype}, index_select + sum), H {h}", library),
                }
            del idx, table, padded, work
    _phase(
        "gather-probe", t0,
        "bench_gather at the script's defaults: " + "; ".join(
            f"{dtype} " + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in res.items()) for dtype, res in tool.items()
        ) + f"; launches {probe_launches}",
    )

    # 19. bench ------------------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    reset_counts()
    # phase 3's graph is the bench's (scale_100k, no dense tier, span 256): not built again
    bench_line = bench.run_bench(scale=True, dense=False, quick=True, graph=graph)
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
        f"warm-up {bench_line['warmup_s']:.2f} s, on phase 3's graph; launches in the timed chunks {timed}",
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
    # the unbroken run's directory stays for phase 29 (step 6 on it)
    life_tmp = tempfile.TemporaryDirectory(prefix="mmgnn_life_")
    tmp = Path(life_tmp.name)
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
    for label in ("unbroken again", "resumed", "faulty"):
        shutil.rmtree(tmp / label, ignore_errors=True)
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
    # phase 24's warm-start runs and phase 27 (f)'s bfloat16 flagship go
    # through the command line beside this phase's: their directories stay
    side_tmp = tempfile.TemporaryDirectory(prefix="mmgnn_side_runs_")
    side_runs = Path(side_tmp.name)
    ws_derived = flagship_band.warm_start_config(flagship, side_runs / "eicu_real_sideinfo.yaml", "sideinfo")
    bf16_flagship = flagship_band.dtype_config(flagship, side_runs / "eicu_real_bf16.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the seeds' command lines (and seed 44 with the CPU's draws, the
        # warm-start and the bfloat16 runs) run side by side on the card: each
        # is its own process over a 1,834-patient graph, so their step
        # seconds are under that load; this process runs the kernel path
        # meanwhile
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=len(FLAGSHIP_SEEDS) + len(WARM_START_SEEDS) + 2) as pool:
            pending = {seed: pool.submit(flagship_band.run_seed, flagship, seed, tmp / f"seed{seed}", device="cuda")
                       for seed in FLAGSHIP_SEEDS}
            # float32 seed 44 stops early on the card (ROADMAP section 3): the
            # same run with the CPU's dropout and supervision draws
            # (tools/cpu_draws.py) trains as the CPU run does
            pending_draws = pool.submit(flagship_band.run_seed, flagship, STREAM_SEED, tmp / "cpu_draws",
                                        device="cuda", steps="1-5", draws="cpu")
            pending_ws = {seed: pool.submit(flagship_band.run_seed, ws_derived, seed, side_runs / f"ws_seed{seed}",
                                            device="cuda") for seed in WARM_START_SEEDS}
            pending_bf16 = pool.submit(flagship_band.run_seed, bf16_flagship, FLAGSHIP_SEEDS[0], side_runs / "bf16",
                                       device="cuda")
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
                for name, _, fn in pipeline.STEPS:  # all eight steps
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
            runs.update({seed: future.result() for seed, future in pending.items()})
            draws = pending_draws.result()
            ws_runs = {seed: future.result() for seed, future in pending_ws.items()}
            bf16_run = pending_bf16.result()
        for seed in FLAGSHIP_SEEDS:
            run = runs[seed]
            print(
                f"    seed {seed}: steps "
                + ", ".join(f"{k} {v:.2f} s" for k, v in run["step_seconds"].items())
                + f"; {run['epochs']} epochs, best val loss {run['best_val_loss']:.6f}; guarded R2 {run['r2']:.6f}, "
                f"MAE {run['mae']:.6f}; per_lab_mean R2 {run['per_lab_mean_r2']:.6f}",
                flush=True,
            )
        print(f"    {_flagship_serving_check(tmp / f'seed{FLAGSHIP_SEEDS[0]}', dev)}", flush=True)
        print(f"    seed {STREAM_SEED} with the CPU's draws on the card: {draws['epochs']} epochs, guarded R2 "
              f"{draws['r2']:.6f} (the card's own draws above: {runs[STREAM_SEED]['epochs']} epochs, R2 "
              f"{runs[STREAM_SEED]['r2']:.6f}; the CPU run: {CPU_SEED44['epochs']} epochs, R2 {CPU_SEED44['r2']:.6f})",
              flush=True)
        print(
            "    seed 42, use_pallas: true, factored heads (in this process, beside the command lines): steps "
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
    flagship_r2_f32 = runs[FLAGSHIP_SEEDS[0]]["r2"]  # phase 27 holds the bfloat16 run to it
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
        f"conf/eicu_real.yaml through python -m multi_modal_gnn_tpu_torch.pipeline (steps 1-8), train seeds "
        f"{list(FLAGSHIP_SEEDS)}: guarded R2 mean {mean_r2:.6f} in [{r2_band[0]:.4f}, {r2_band[1]:.4f}], MAE mean "
        f"{mean_mae:.6f} in [{mae_band[0]:.4f}, {mae_band[1]:.4f}]; the use_pallas run launched {pipeline_launches}, "
        f"and K4f / K4b match their plain versions on its train batch and trained heads",
    )

    # 22. serving-export ---------------------------------------------------
    t0 = time.perf_counter()
    from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta
    from multi_modal_gnn_tpu_torch.serving import ServingModel, export_serving

    rng = np.random.default_rng(22)
    serve_requests = [("patient", int(p)) for p in rng.integers(0, num_p, SERVE_PATIENTS)] + [
        ("pairs", (rng.integers(0, num_p, n), rng.integers(0, num_l, n))) for n in (*SERVE_BATCHES, SERVE_CHUNKED)
    ]
    export_launches, serving_times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # phase 5's seeded RGCN on phase 3's graph, phase 12's HGT on its
        # plans, and phase 5's RGCN in bfloat16 (its bf16 leaves stored as
        # bit patterns)
        rgcn_bf16 = dataclasses.replace(config, model=dataclasses.replace(config.model, compute_dtype="bfloat16"))
        for arch, cfg, g, must_launch in (
            ("RGCN", config, graph, ("segment_sum_windowed", "fused_table_segment_sum", "span_segment_sum")),
            ("HGT", hgt_config, graph_hgt, ("flash_attention_fwd",)),
            ("RGCN bf16", rgcn_bf16, graph,
             ("segment_sum_windowed_bf16", "fused_table_segment_sum_bf16", "span_segment_sum_bf16")),
        ):
            if arch.startswith("RGCN"):
                model = build_model(cfg, graph_cpu, device="cpu", generator=torch.Generator().manual_seed(0)).to(dev)
            else:
                model = build_model(cfg, graph_cpu, generator=torch.Generator().manual_seed(0))
            trainer = Trainer(model, g, masker, cfg)
            reset_counts()
            t = time.perf_counter()
            export_serving(trainer, GraphBundle(graph=g, meta=GraphMeta()), tmp / arch)
            torch.cuda.synchronize()
            export_s = time.perf_counter() - t
            launched = {k: v for k, v in {**sk.launch_counts, **ak.launch_counts}.items() if v}
            if not all(launched.get(k) for k in must_launch):
                raise AssertionError(f"{arch} export: a kernel of compute_node_state did not launch: {launched}")
            export_launches.update(launched)
            sizes = {f.name: f.stat().st_size for f in sorted((tmp / arch).iterdir())}
            programs = sum(n for name, n in sizes.items() if name.endswith(".pt2"))
            if not programs < 0.01 * sizes["weights.npz"]:
                raise AssertionError(f"{arch} artifact: the programs ({programs} B) are not under 1 % of weights.npz")
            t = time.perf_counter()
            served = ServingModel.load(tmp / arch)
            load_s = time.perf_counter() - t
            print(
                f"    {arch}: export {export_s:.3f} s (launches {launched}); files {sizes}: programs {programs} B, "
                f"{100 * programs / sizes['weights.npz']:.4f} % of weights.npz; load with {len(served.buckets)} "
                f"CUDA graph captures {load_s:.3f} s",
                flush=True,
            )
            fn, _ = build_serving_fn(model, g)
            serving_times[arch] = {
                "export_s": export_s, "load_s": load_s, "bytes": sizes,
                **_served_vs_eager(served, fn, serve_requests if arch.startswith("RGCN") else serve_requests[:SERVE_PATIENTS],
                                   num_l, arch),
            }
            if arch == "RGCN bf16":
                manifest = json.loads((tmp / arch / "serving.json").read_text())
                bf16_leaves = [n for n, t in zip(manifest["leaves"], manifest["leaf_dtypes"]) if t == "bfloat16"]
                f32_bytes = serving_times["RGCN"]["bytes"]["weights.npz"]
                print(f"    RGCN bf16: weights.npz {sizes['weights.npz']} B against the float32 artifact's {f32_bytes} B "
                      f"({sizes['weights.npz'] / f32_bytes:.4f}); bfloat16 leaves (uint16 bit patterns) {bf16_leaves}",
                      flush=True)
                if not bf16_leaves:
                    raise AssertionError("the bf16 RGCN's artifact holds no bfloat16 leaf")
            # the device time of a request: each bucket's graph replayed alone
            serving_times[arch]["replay_ms"] = {b: _median_ms(served._buckets[b].graph.replay) for b in served.buckets}
            print(
                f"    {arch} CUDA graph replay alone (CUDA events, median of {TIMING_REPS}): " + ", ".join(
                    f"bucket {b} {ms:.4f} ms" for b, ms in serving_times[arch]["replay_ms"].items()
                ),
                flush=True,
            )
            if arch == "RGCN":  # the card's artifact on the CPU
                t = time.perf_counter()
                on_cpu = ServingModel.load(tmp / arch, device="cpu")
                p_req, l_req = serve_requests[SERVE_PATIENTS][1]
                _compare("RGCN artifact exported on the card, loaded on the CPU: 256 pairs",
                         torch.from_numpy(on_cpu.predict(p_req, l_req)), torch.from_numpy(served.predict(p_req, l_req)),
                         SERVE_ATOL, SERVE_RTOL)
                print(f"    the card's artifact on the CPU: load and one request {time.perf_counter() - t:.3f} s")
                del on_cpu
            del model, trainer, served, fn
            torch.cuda.empty_cache()
        # a CPU artifact on the card
        cfg_cpu = Config(model=ModelConfig(hidden_dim=32))
        g_tiny = make_synthetic_graph(SyntheticSpec.tiny(), cfg_cpu, device="cpu")
        model = build_model(cfg_cpu, g_tiny, device="cpu", generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, g_tiny, masker_from_config(cfg_cpu, g_tiny), cfg_cpu, device="cpu")
        export_serving(trainer, GraphBundle(graph=g_tiny, meta=GraphMeta()), tmp / "cpu", buckets=(64,))
        fn, _ = build_serving_fn(model, g_tiny)
        p_req = rng.integers(0, g_tiny.num_nodes(PATIENT), 100)
        l_req = rng.integers(0, g_tiny.num_nodes(LAB), 100)
        _compare("tiny RGCN artifact exported on the CPU, loaded on the card: 100 pairs",
                 torch.from_numpy(ServingModel.load(tmp / "cpu").predict(p_req, l_req)), fn(p_req, l_req),
                 SERVE_ATOL, SERVE_RTOL)
        del model, trainer, fn
    torch.cuda.empty_cache()
    _phase(
        "serving-export", t0,
        "export_serving / ServingModel on the card for the RGCN (K1, K2f, K3 in its export), the HGT (K6) and the "
        "RGCN in bfloat16 (their bf16 instantiations): "
        "answers within the eager serving path's, the programs under 1 % of weights.npz, the card's artifact "
        "on the CPU and a CPU artifact on the card; p50 artifact / eager: " + "; ".join(
            f"{arch} {kind} {t['artifact_p50_ms']:.4f} / {t['eager_p50_ms']:.4f} ms"
            for arch, times in serving_times.items() for kind, t in times.items() if isinstance(t, dict) and "eager_p50_ms" in t
        ),
    )

    # 23. value-context ----------------------------------------------------
    t0 = time.perf_counter()
    from multi_modal_gnn_tpu_torch.graph.schema import PATIENT_LAB
    from multi_modal_gnn_tpu_torch.models import context as context_mod
    from multi_modal_gnn_tpu_torch.models.context import inject_value_context, patient_value_context

    def channel_config(base, source, rank, value_context=True, dropout=0.0, **model_extras):
        mc = base.model
        head = dataclasses.replace(mc.edge_head, extras={"bilinear_rank": rank, "bilinear_source": source})
        extras = {**mc.extras, "value_context": value_context, **model_extras}
        return dataclasses.replace(
            base, model=dataclasses.replace(mc, dropout=dropout, extras=extras, edge_head=head)
        )

    def with_values(g, val):
        es = g.edges[PATIENT_LAB]
        return dataclasses.replace(g, edges={**g.edges, PATIENT_LAB: dataclasses.replace(es, val=val)})

    # (a) one Adam step, dropout 0, the card's kernels against the CPU's plain versions
    vc0 = channel_config(config, "context", VC_RANK)
    model_gpu = build_model(vc0, graph_cpu, generator=torch.Generator().manual_seed(0))
    model_ref = build_model(vc0, graph_cpu, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model_gpu, graph, masker, vc0)
    trainer_ref = Trainer(model_ref, graph_cpu, masker, vc0, device="cpu")
    sup = masker.supervision_mask(0, batch_cpu)
    b_gpu, b_ref = trainer.get_batch("train"), trainer_ref.get_batch("train")
    reset_counts()
    t_step = time.perf_counter()
    loss = trainer.train_step(b_gpu, sup.to(dev), 0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_step) * 1e3
    vc_launches = read_counts()
    if not all(vc_launches.values()):
        raise AssertionError(f"a kernel of the value-context training path did not launch: {vc_launches}")
    t_ref = time.perf_counter()
    loss_ref = trainer_ref.train_step(b_ref, sup, 0)
    ref_s = time.perf_counter() - t_ref
    _compare("value-context train step loss", torch.tensor(loss), torch.tensor(loss_ref), 0.0, STEP_LOSS_RTOL)
    params = dict(model_gpu.named_parameters())
    floor = STEP_GRAD_ZERO_FLOOR * max(float(p.grad.norm()) for p in model_ref.parameters())
    failed_grads = [
        name for name, p_ref in model_ref.named_parameters()
        if not _compare_norm(f"value-context grad {name}", params[name].grad, p_ref.grad, STEP_GRAD_NORM_REL, floor)
    ]
    for name, p_ref in model_ref.named_parameters():
        diff = float((params[name].detach().cpu() - p_ref.detach()).abs().max())
        if diff > STEP_PARAM_ATOL:
            raise AssertionError(f"value-context param {name}: max |d| {diff:.3e} > {STEP_PARAM_ATOL}")
    if failed_grads:
        raise AssertionError(f"value-context train-step gradients outside tolerance: {failed_grads}")
    print(
        f"    (a) context source, rank {VC_RANK}: loss {loss:.6f} (CPU plain {loss_ref:.6f}); first step on the "
        f"card {step_ms:.1f} ms, CPU plain step {ref_s:.1f} s; parameters within {STEP_PARAM_ATOL:g}; "
        f"launches {vc_launches}",
        flush=True,
    )
    del model_ref, trainer_ref

    # (b) leakage: the step's predictions with the supervised train edges',
    # val and test values perturbed, against the drift of unperturbed runs
    sup_dev = sup.to(dev)
    g_vis = trainer._visible_graph(sup_dev)

    def step_preds(g):
        with torch.no_grad():
            model_gpu.train()
            out = model_gpu.predict_lab_values(
                g, b_gpu.patient_idx, b_gpu.lab_idx, train=True, patient_plan=b_gpu.patient_plan,
                lab_plan=b_gpu.lab_plan, degrees=b_gpu.degrees,
            )
        return out[b_gpu.valid > 0]

    def perturbed(positions, seed):
        val = g_vis.edges[PATIENT_LAB].val.clone()
        pos = torch.from_numpy(np.asarray(positions)).long().to(dev)
        noise = torch.randn(len(positions), generator=torch.Generator().manual_seed(seed)) * 3.0 + 5.0
        val[pos] = noise.to(dev)
        return with_values(g_vis, val)

    hidden = np.concatenate([
        masker.train_positions()[sup.numpy() > 0], masker.split_edge_positions("val"),
        masker.split_edge_positions("test"),
    ])
    plain_runs = [step_preds(g_vis) for _ in range(4)]
    drift = max(float((a - b).abs().max()) for i, a in enumerate(plain_runs) for b in plain_runs[i + 1:])
    # a hidden value read by the forward would move every perturbed run: the
    # leak is the closest any perturbed run comes to an unperturbed one
    leak_runs = [step_preds(perturbed(hidden, 1)) for _ in range(2)]
    leak = min(float((p - a).abs().max()) for p in leak_runs for a in plain_runs)
    visible = masker.train_positions()[(sup.numpy() == 0) & (b_ref.valid.numpy() > 0)]
    live = float((step_preds(perturbed(visible, 2)) - plain_runs[0]).abs().max())
    print(
        f"    (b) leakage: {len(hidden)} supervised, val and test values perturbed move the step's predictions "
        f"by {leak:.3e} (the closest of 2 perturbed runs to 4 unperturbed ones); the unperturbed runs differ "
        f"by up to {drift:.3e}; the "
        f"{len(visible)} visible train values perturbed move them by {live:.3e}",
        flush=True,
    )
    if not leak <= drift:
        raise AssertionError(f"value leak: hidden values move the step's predictions by {leak:.3e} > drift {drift:.3e}")
    if not live > 1e3 * max(drift, 1e-7):
        raise AssertionError(f"the value channel reads no visible value: {live:.3e}")
    del model_gpu, trainer, g_vis, plain_runs, leak_runs
    torch.cuda.empty_cache()

    # (c) five epochs, dropout 0.2; the context sums timed alone
    vc_train = channel_config(config, "context", VC_RANK, dropout=config.model.dropout)
    model = build_model(vc_train, graph_cpu, generator=torch.Generator().manual_seed(1))
    trainer = Trainer(model, graph, masker, vc_train)
    trainer.train_epoch()
    trainer.epoch += 1
    torch.cuda.synchronize()
    vc_epoch_ms, vc_losses = [], []
    for _ in range(TRAIN_EPOCHS):
        t_ep = time.perf_counter()
        vc_losses.append(trainer.train_epoch())
        torch.cuda.synchronize()
        vc_epoch_ms.append((time.perf_counter() - t_ep) * 1e3)
        trainer.epoch += 1
    if not all(np.isfinite(vc_losses)):
        raise AssertionError(f"non-finite value-context training loss: {vc_losses}")
    vc_val = trainer.validate("val")
    if not np.isfinite(vc_val):
        raise AssertionError(f"non-finite value-context validation loss {vc_val}")
    vc_edges_per_s = n_train * TRAIN_EPOCHS / (sum(vc_epoch_ms) / 1e3)
    print(f"    (c) losses {['%.6f' % x for x in vc_losses]}  val loss {vc_val:.6f}")
    print(f"    (c) epoch ms {['%.2f' % x for x in vc_epoch_ms]}")
    wall_ms, busy_ms, top = _device_profile(trainer.train_epoch)
    print(
        f"    (c) profiled epoch: wall {wall_ms:.2f} ms  device busy {busy_ms:.2f} ms  "
        f"idle share {max(0.0, 1 - busy_ms / wall_ms):.4f}"
    )
    for name, ms in top[:12]:
        print(f"      {ms:9.3f} ms  {100 * ms / max(busy_ms, 1e-9):5.1f} %  {name[:130]}")
    g_vis = trainer._visible_graph(masker.supervision_mask(0, b_gpu))
    es = g_vis.edges[PATIENT_LAB]
    x_p = torch.randn(num_p, d, device=dev, requires_grad=True)
    x_l = torch.randn(num_l, d, device=dev, requires_grad=True)
    g_p, g_l = torch.randn(num_p, d, device=dev), torch.randn(num_l, d, device=dev)

    def inject():
        return inject_value_context({PATIENT: x_p, LAB: x_l}, g_vis, model.vctx_patient, model.vctx_lab)

    def inject_bwd():
        out = inject()
        torch.autograd.backward([out[PATIENT], out[LAB]], [g_p, g_l])

    def context_bwd():
        ctx, _ = patient_value_context(x_l, es)
        ctx.backward(g_p)

    def time_context_sums():
        with torch.no_grad():
            times = {"inject forward": _median_ms(inject), "context term forward": _median_ms(
                lambda: patient_value_context(x_l, es))}
        times["inject forward + backward"] = _median_ms(inject_bwd)
        times["context term forward + backward"] = _median_ms(context_bwd)
        return times

    # the route the path takes (sparse products over the ValuePlan), then the
    # plain index_add_ route (JAX's form) on the same inputs
    ctx_ms = time_context_sums()
    csr_route = context_mod.csr_route
    context_mod.csr_route = lambda es, device: False
    try:
        ctx_plain_ms = time_context_sums()
    finally:
        context_mod.csr_route = csr_route
    # the context term's narrow row gathers, at its rank and at one more
    # (PyTorch takes another gather kernel for rows that are not 16-byte
    # multiples)
    gather_ms = {}
    for rank in (VC_RANK, VC_RANK + 1):
        for side, rows, idx in (("patient", num_p, b_gpu.patient_idx), ("lab", num_l, b_gpu.lab_idx)):
            table, index = torch.randn(rows, rank, device=dev), idx.long()
            gather_ms[(side, rank)] = _median_ms(lambda table=table, index=index: table.index_select(0, index))
    print(
        f"    (c) the bilinear term's row gathers (index_select of {b_gpu.patient_idx.shape[0]} slots, CUDA "
        "events): " + ", ".join(f"{side} table at rank {rank} {ms:.4f} ms" for (side, rank), ms in gather_ms.items()),
        flush=True,
    )
    # each side reads E values, E column indices and its table once and
    # writes its sums once
    ctx_bytes = 2 * es.num_valid * 8 + 2 * (num_p + num_l) * d * 4
    print(
        "    (c) the context sums alone (CUDA events, median of "
        f"{TIMING_REPS}; E {es.num_valid}, D {d}), sparse-product route / index_add_ route: "
        + ", ".join(f"{k} {v:.4f} / {ctx_plain_ms[k]:.4f} ms" for k, v in ctx_ms.items())
        + f"; both sides' bytes at the HBM rate {ctx_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms",
        flush=True,
    )
    del model, trainer, g_vis, es, x_p, x_l, g_p, g_l
    torch.cuda.empty_cache()

    # (d) the head source with dual_head_fusion on: single heads (K4), no K5
    head_cfg = channel_config(dual_config, "head", VC_RANK, dual_head_fusion="on")
    model = build_model(head_cfg, graph_cpu, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, graph, masker0, head_cfg)
    b0 = trainer.get_batch("train")
    reset_counts()
    head_loss = trainer.train_step(b0, masker0.supervision_mask(0, b0), 0)
    torch.cuda.synchronize()
    head_launches = read_counts(HEAD_PATH_KERNELS)
    if not (head_launches["pair_head_fwd"] and head_launches["pair_head_bwd"]) or (
        head_launches["pair_head_dual_fwd"] or head_launches["pair_head_dual_bwd"]
    ):
        raise AssertionError(f"the head source with dual_head_fusion on must run K4 and not K5: {head_launches}")
    if not np.isfinite(head_loss):
        raise AssertionError(f"non-finite head-source loss {head_loss}")
    print(f"    (d) head source, rank {VC_RANK}, dual_head_fusion on, lab_tile_rows 0: loss {head_loss:.6f}; "
          f"launches {head_launches}", flush=True)
    del model, trainer, b0
    torch.cuda.empty_cache()

    # (e) the HGT on phase 3's graph, flash tier against the segment tier,
    # value context and the embedding source at rank VC_HGT_RANK
    def hgt_vc_steps(g_flash, g_seg, g_cpu, hgt_masker, base=hgt_config):
        cfg = channel_config(base, "embedding", VC_HGT_RANK)
        cfg_seg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, extras={**cfg.model.extras, "hgt_flash": "off"}))
        sup_h = hgt_masker.supervision_mask(0, hgt_masker.get_split("train")).to(dev)
        out = {}
        for tier, c, g in (("flash", cfg, g_flash), ("segment", cfg_seg, g_seg)):
            model_h = build_model(c, g_cpu, generator=torch.Generator().manual_seed(0))
            trainer_h = Trainer(model_h, g, hgt_masker, c)
            b = trainer_h.get_batch("train")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t_step = time.perf_counter()
            loss_h = trainer_h.train_step(b, sup_h, 0)
            torch.cuda.synchronize()
            out[tier] = dict(
                loss=loss_h, ms=(time.perf_counter() - t_step) * 1e3,
                peak_gb=torch.cuda.max_memory_allocated() / 2**30, launches=dict(ak.launch_counts),
                grads={n: p.grad.detach().cpu() for n, p in model_h.named_parameters()},
                params={n: p.detach().cpu() for n, p in model_h.named_parameters()},
            )
            del model_h, trainer_h, b
            torch.cuda.empty_cache()
        return out

    steps = hgt_vc_steps(graph_hgt, graph_seg, graph_cpu, masker)
    flash, seg = steps["flash"], steps["segment"]
    if not all(flash["launches"].values()) or any(seg["launches"].values()):
        raise AssertionError(f"launches: flash tier {flash['launches']}, segment tier {seg['launches']}")
    _compare("HGT value-context step loss, flash vs segment tier", torch.tensor(flash["loss"]),
             torch.tensor(seg["loss"]), 0.0, STEP_LOSS_RTOL)
    floor = STEP_GRAD_ZERO_FLOOR * max(float(g.norm()) for g in seg["grads"].values())
    failed_hgt = [
        name for name, g in seg["grads"].items()
        if not _compare_norm(f"HGT value-context grad {name}", flash["grads"][name], g, HGT_STEP_GRAD_NORM_REL, floor)
    ]
    for name, p_seg in seg["params"].items():
        diff = float((flash["params"][name] - p_seg).abs().max())
        if diff > STEP_PARAM_ATOL:
            raise AssertionError(f"HGT value-context param {name}: max |d| {diff:.3e} > {STEP_PARAM_ATOL}")
    if failed_hgt:
        raise AssertionError(f"HGT value-context gradients outside tolerance: {failed_hgt}")
    vc_hgt_launches = flash["launches"]
    print(
        f"    (e) HGT on phase 3's scale_100k graph, embedding source rank {VC_HGT_RANK}: loss {flash['loss']:.6f} "
        f"(segment tier {seg['loss']:.6f}); first step flash {flash['ms']:.1f} ms, peak {flash['peak_gb']:.2f} GiB; "
        f"segment {seg['ms']:.1f} ms, peak {seg['peak_gb']:.2f} GiB (torch.cuda.max_memory_allocated); "
        f"launches {vc_hgt_launches}",
        flush=True,
    )
    del steps, flash, seg
    torch.cuda.empty_cache()

    # (f) the value context in bfloat16: the RGCN's step on the card against
    # the CPU plain step at phase 27's bounds, its launches, the leak check
    # of (b), and the context sums in bfloat16 against float32, in turns
    bf = torch.bfloat16

    def with_bf16(base):
        return dataclasses.replace(base, model=dataclasses.replace(base.model, compute_dtype="bfloat16"))

    vc_bf = channel_config(with_bf16(config), "context", VC_RANK)
    model_gpu = build_model(vc_bf, graph_cpu, generator=torch.Generator().manual_seed(0))
    model_ref = build_model(vc_bf, graph_cpu, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model_gpu, graph, masker, vc_bf)
    trainer_ref = Trainer(model_ref, graph_cpu, masker, vc_bf, device="cpu")
    b_gpu, b_ref = trainer.get_batch("train"), trainer_ref.get_batch("train")
    reset_counts()
    loss = trainer.train_step(b_gpu, sup.to(dev), 0)
    torch.cuda.synchronize()
    counts = {**sk.launch_counts, **pk.launch_counts}
    vc_bf16_launches = {name: counts[name + "_bf16"] for name in RGCN_KERNELS}
    vc_bf16_f32 = read_counts()
    if not (all(vc_bf16_launches[n] for n in RGCN_KERNELS if n != "fused_table_segment_sum_bwd")
            and vc_bf16_f32["fused_table_segment_sum_bwd"]):
        raise AssertionError(f"(f) the bf16 value-context step: bf16 launches {vc_bf16_launches}, float32 "
                             f"{vc_bf16_f32}: K1, K2f, K3, K4f, K4b in bf16 and K2b in float32 must launch")
    t_ref = time.perf_counter()
    loss_ref = trainer_ref.train_step(b_ref, sup, 0)
    ref_s = time.perf_counter() - t_ref
    _compare("(f) bf16 value-context step loss", torch.tensor(loss), torch.tensor(loss_ref), 0.0, BF16_LOSS_RTOL)
    _bf16_grads_close("(f) bf16 value-context step, card vs CPU plain",
                      {n: p.grad for n, p in model_gpu.named_parameters()},
                      {n: p.grad for n, p in model_ref.named_parameters()}, zero=_vctx_rgcn_zero)
    params = dict(model_gpu.named_parameters())
    for name, p_ref in model_ref.named_parameters():
        diff = float((params[name].detach().cpu() - p_ref.detach()).abs().max())
        if diff > STEP_PARAM_ATOL:
            raise AssertionError(f"(f) bf16 value-context param {name}: max |d| {diff:.3e} > {STEP_PARAM_ATOL}")
    print(f"    (f) bf16, context source rank {VC_RANK}: loss {loss:.6f} (CPU plain {loss_ref:.6f}, {ref_s:.1f} s); "
          f"params within {STEP_PARAM_ATOL:g}; bf16 launches {vc_bf16_launches}; float32 launches {vc_bf16_f32}",
          flush=True)
    del model_ref, trainer_ref
    g_vis = trainer._visible_graph(sup.to(dev))  # step_preds and perturbed read model_gpu, b_gpu, g_vis
    plain_runs = [step_preds(g_vis) for _ in range(4)]
    drift_bf = max(float((a - b).abs().max()) for i, a in enumerate(plain_runs) for b in plain_runs[i + 1:])
    leak_bf = min(float((p - a).abs().max()) for p in [step_preds(perturbed(hidden, 1)) for _ in range(2)]
                  for a in plain_runs)
    live_bf = float((step_preds(perturbed(visible, 2)) - plain_runs[0]).abs().max())
    print(f"    (f) bf16 leakage: hidden values perturbed move the step's predictions by {leak_bf:.3e} (the closest "
          f"of 2 perturbed runs to 4 unperturbed ones); the unperturbed runs differ by up to {drift_bf:.3e}; the "
          f"visible train values perturbed move them by {live_bf:.3e}", flush=True)
    if not leak_bf <= drift_bf:
        raise AssertionError(f"(f) bf16 value leak: {leak_bf:.3e} > drift {drift_bf:.3e}")
    if not live_bf > VC_LIVE_FACTOR_BF16 * max(drift_bf, 1e-7):
        raise AssertionError(f"(f) the bf16 value channel reads no visible value: {live_bf:.3e}")
    # the context sums of both sides (the bf16 RGCN's tables: patient rows
    # in bf16, lab rows in float32), forward and backward, bf16 against
    # float32 patient rows in turns (bf16, f32, f32, bf16)
    es = g_vis.edges[PATIENT_LAB]
    x_l = torch.randn(num_l, d, device=dev, requires_grad=True)
    x_ps = {dtype: torch.randn(num_p, d, device=dev).to(dtype).requires_grad_() for dtype in (bf, torch.float32)}
    g_p, g_l = torch.randn(num_p, d, device=dev), torch.randn(num_l, d, device=dev)

    def sums(dtype, backward):
        s_ = context_mod._Sums(es, dev)
        (wsum_l, _), (wsum_p, _) = s_.lab(x_ps[dtype]), s_.patient(x_l)
        if backward:
            torch.autograd.backward([wsum_l, wsum_p], [g_l.to(wsum_l.dtype), g_p])

    vc_sums = {}
    for backward in (False, True):
        with torch.set_grad_enabled(backward):
            t = [_median_ms(lambda dt=dt: sums(dt, backward)) for dt in (bf, torch.float32, torch.float32, bf)]
        vc_sums["forward + backward" if backward else "forward"] = {"bf16_ms": (t[0] + t[3]) / 2,
                                                                    "f32_ms": (t[1] + t[2]) / 2, "turns_ms": t}
    # the library yardstick: one torch.sparse.mm of a bfloat16 CSR matrix and
    # the bf16 rows (the route the port does not take), its error against the
    # float32 sums of the same bfloat16 operands beside the port's
    with torch.no_grad():
        e = es.num_valid
        v = (es.val * es.val_vis)[:e].to(bf)
        a_bf = torch.sparse_csr_tensor(es.row_ptr, es.src[:e], v, (es.num_dst, es.num_src), check_invariants=False)
        a_32 = torch.sparse_csr_tensor(es.row_ptr, es.src[:e], v.float(), (es.num_dst, es.num_src),
                                       check_invariants=False)
        xb = x_ps[bf].detach()
        ref = torch.sparse.mm(a_32, xb.float())
        ours = context_mod._Sums(es, dev).lab(xb)[0].float()
        native = torch.sparse.mm(a_bf, xb).float()
        native_ms = _median_ms(lambda: torch.sparse.mm(a_bf, xb))
    ours_err, native_err = float((ours - ref).abs().max()), float((native - ref).abs().max())
    scale = float(ref.abs().max())
    print("    (f) the context sums, bf16 / float32 patient rows (CUDA events, median of "
          f"{TIMING_REPS}, in turns): " + ", ".join(f"{k} {v['bf16_ms']:.4f} / {v['f32_ms']:.4f} ms" for k, v in
                                                   vc_sums.items())
          + f"; the lab side against the float32 sums of its bf16 operands (max|ref| {scale:.3e}): the port's "
          f"{ours_err:.3e} (rounded once), torch.sparse.mm on a bf16 CSR {native_err:.3e} in {native_ms:.4f} ms",
          flush=True)
    if not ours_err <= BF16_ULP * scale:
        raise AssertionError(f"(f) the bf16 context sums are {ours_err:.3e} off their float32 sums")
    del model_gpu, trainer, g_vis, plain_runs, es, x_l, x_ps, a_bf, a_32, xb, ref, ours, native
    torch.cuda.empty_cache()

    # (g) the HGT with value context in bfloat16 (its vctx projections only),
    # flash tier against segment tier at phase 27's bounds
    steps = hgt_vc_steps(graph_hgt, graph_seg, graph_cpu, masker, base=with_bf16(hgt_config))
    flash, seg = steps["flash"], steps["segment"]
    if not all(flash["launches"].values()) or any(seg["launches"].values()):
        raise AssertionError(f"(g) launches: flash tier {flash['launches']}, segment tier {seg['launches']}")
    _compare("(g) bf16 HGT value-context step loss, flash vs segment tier", torch.tensor(flash["loss"]),
             torch.tensor(seg["loss"]), 0.0, BF16_LOSS_RTOL)
    _bf16_grads_close("(g) bf16 HGT value-context step, flash vs segment", flash["grads"], seg["grads"])
    for name, p_seg in seg["params"].items():
        diff = float((flash["params"][name] - p_seg).abs().max())
        if diff > STEP_PARAM_ATOL:
            raise AssertionError(f"(g) bf16 HGT value-context param {name}: max |d| {diff:.3e} > {STEP_PARAM_ATOL}")
    print(f"    (g) bf16 HGT, embedding source rank {VC_HGT_RANK}: loss {flash['loss']:.6f} (segment tier "
          f"{seg['loss']:.6f}); peak flash {flash['peak_gb']:.2f} GiB; launches {flash['launches']}", flush=True)
    del steps, flash, seg
    torch.cuda.empty_cache()
    _phase(
        "value-context", t0,
        f"(a) the step on the card matches the CPU plain step; (b) leak {leak:.3e} <= drift {drift:.3e}; "
        f"(c) {TRAIN_EPOCHS} epochs, dropout {vc_train.model.dropout}: median epoch "
        f"{statistics.median(vc_epoch_ms):.2f} ms  train_patient_lab_edges_per_sec {vc_edges_per_s:.1f} "
        f"(phase 9 without the channels: {rgcn_train[0]:.2f} ms, {rgcn_train[1]:.1f}); context sums "
        f"forward {ctx_ms['inject forward']:.4f} + {ctx_ms['context term forward']:.4f} ms (index_add_: "
        f"{ctx_plain_ms['inject forward']:.4f} + {ctx_plain_ms['context term forward']:.4f}); (d) K4 without K5; "
        f"(e) HGT flash matches segment; (f) bf16: the step matches the CPU plain step, leak {leak_bf:.3e} <= drift "
        f"{drift_bf:.3e}, context sums bf16 / f32 forward {vc_sums['forward']['bf16_ms']:.4f} / "
        f"{vc_sums['forward']['f32_ms']:.4f} ms; (g) bf16 HGT flash matches segment",
    )

    # 24. warm-start -------------------------------------------------------
    t0 = time.perf_counter()
    from multi_modal_gnn_tpu_torch.config import load_config
    from multi_modal_gnn_tpu_torch.serving import ServingModel
    from multi_modal_gnn_tpu_torch.evaluation.baselines import SideInfoALSBaseline
    from multi_modal_gnn_tpu_torch.training import warm_start_from_config
    from multi_modal_gnn_tpu_torch.utils.rng import stream_seed

    # the runs went through the command line beside phase 21's (ws_runs)
    for seed, run in ws_runs.items():
        print(
            f"    seed {seed} (run in phase 21's pool): steps "
            + ", ".join(f"{k} {v:.2f} s" for k, v in run["step_seconds"].items())
            + f"; {run['epochs']} epochs, best val loss {run['best_val_loss']:.6f}; guarded R2 {run['r2']:.6f}, "
            f"MAE {run['mae']:.6f}; per_lab_mean R2 {run['per_lab_mean_r2']:.6f}",
            flush=True,
        )
    # seed 42's plant on the card, from its own graph and split
    run_dir = side_runs / f"ws_seed{FLAGSHIP_SEEDS[0]}"
    cfg = load_config(run_dir / "config.yaml")
    opts = pipeline.RunOptions(device=dev)
    bundle = pipeline._load_bundle(cfg, opts)
    ws_cfg = cfg
    ws_masker = masker_from_config(ws_cfg, bundle.graph)
    ws_model = build_model(
        ws_cfg, bundle.graph, generator=torch.Generator().manual_seed(stream_seed(cfg.train.seed, "init"))
    )
    ws_trainer = Trainer(ws_model, bundle.graph, ws_masker, ws_cfg)
    baseline = warm_start_from_config(ws_trainer, ws_cfg)
    if not isinstance(baseline, SideInfoALSBaseline):
        raise AssertionError(f"the derived config planted {type(baseline).__name__}, not SideInfoALSBaseline")
    val_p, val_l, _ = ws_masker.split_arrays("val")
    plant_err, _ = _compare(
        f"seed {FLAGSHIP_SEEDS[0]}: val predictions right after the plant against SideInfoALSBaseline.predict",
        torch.from_numpy(ws_trainer.predict("val")).double(), torch.from_numpy(baseline.predict(val_p, val_l)),
        WARM_START_ATOL, 0.0,
    )
    plant_loss = ws_trainer.best_val_loss
    if not ws_runs[FLAGSHIP_SEEDS[0]]["best_val_loss"] <= plant_loss * (1 + 1e-6):
        raise AssertionError(
            f"best val loss {ws_runs[FLAGSHIP_SEEDS[0]]['best_val_loss']:.6f} is above the plant's {plant_loss:.6f}"
        )
    served = ServingModel.load(run_dir / "out" / "serving", device=dev)
    if not {"state.bl_u", "state.bl_l"} <= set(served.manifest["leaves"]):
        raise AssertionError(f"the warm-started artifact carries no bl_u / bl_l: {served.manifest['leaves']}")
    trainer = pipeline._load_trainer(cfg, bundle, opts, require_checkpoint=True)
    test_p, test_l, _ = trainer.masker.split_arrays("test")
    served_err, _ = _compare(
        f"seed {FLAGSHIP_SEEDS[0]}: the warm-started artifact on {len(test_p)} test pairs against the trainer",
        torch.from_numpy(served.predict(test_p, test_l)), torch.from_numpy(trainer.predict_pairs(test_p, test_l)),
        SERVE_ATOL, SERVE_RTOL,
    )
    derived_text = ws_derived.read_text()
    del ws_model, ws_trainer, trainer, served, bundle
    for label, run in ws_runs.items():
        if run["missing"]:
            raise AssertionError(f"warm-start run {label}: artifacts missing: {run['missing']}")
        if run["leak"]:
            raise AssertionError(f"warm-start run {label}: the audit reports a leak")
    ws_r2_band = (min(JAX_CPU_BAND_SIDEINFO["r2"]) - FLAGSHIP_R2_MARGIN,
                  max(JAX_CPU_BAND_SIDEINFO["r2"]) + FLAGSHIP_R2_MARGIN)
    ws_mae_band = (min(JAX_CPU_BAND_SIDEINFO["mae"]) - FLAGSHIP_MAE_MARGIN,
                   max(JAX_CPU_BAND_SIDEINFO["mae"]) + FLAGSHIP_MAE_MARGIN)
    ws_r2 = statistics.fmean(r["r2"] for r in ws_runs.values())
    ws_mae = statistics.fmean(r["mae"] for r in ws_runs.values())
    if not (ws_r2_band[0] <= ws_r2 <= ws_r2_band[1] and ws_mae_band[0] <= ws_mae <= ws_mae_band[1]):
        raise AssertionError(
            f"warm start: {len(ws_runs)}-seed mean guarded R2 {ws_r2:.6f} / MAE {ws_mae:.6f} outside the band R2 "
            f"[{ws_r2_band[0]:.4f}, {ws_r2_band[1]:.4f}], MAE [{ws_mae_band[0]:.4f}, {ws_mae_band[1]:.4f}]"
        )
    changed = [name for name, state in guarded.items() if _tree_state(repo / name) != state]
    if changed:
        raise AssertionError(f"the warm-start runs wrote into the repo: {changed}")
    print("    the derived config's warm-start lines: " + "; ".join(
        ln.strip() for ln in derived_text.splitlines() if "warm_start" in ln or "bilinear" in ln))
    _phase(
        "warm-start", t0,
        f"conf/eicu_real.yaml with train.extras.warm_start: sideinfo (channel wired: bilinear_rank 17, "
        f"embedding) through the command line, seeds {list(WARM_START_SEEDS)}: guarded R2 mean {ws_r2:.6f} in "
        f"[{ws_r2_band[0]:.4f}, {ws_r2_band[1]:.4f}], MAE mean {ws_mae:.6f} in [{ws_mae_band[0]:.4f}, "
        f"{ws_mae_band[1]:.4f}] (the JAX package's, CPU); the plant equals SideInfoALSBaseline within "
        f"{plant_err:.2e}, best val loss {ws_runs[FLAGSHIP_SEEDS[0]]['best_val_loss']:.6f} <= the plant's "
        f"{plant_loss:.6f}; the artifact (bl_u / bl_l) within {served_err:.2e} of the trainer",
    )

    def counts_of():
        counts = {**sk.launch_counts, **pk.launch_counts, **ak.launch_counts, **gp.launch_counts}
        return {name: counts.get(name, 0) for name in KERNELS}

    # 25. clusters ---------------------------------------------------------
    t0 = time.perf_counter()
    clusters = _clusters_phase(dev, graph_cpu, graph, graph_hgt, config, masker, reset_counts, counts_of)
    cs = clusters["summary"]
    _phase(
        "clusters", t0,
        f"(a) K {CLUSTER_K} partition exact, built in {cs['build_s']:.2f} s; (b) the cluster step on the card "
        f"matches the CPU plain step; (c) K1, K2f, K2b match at K {CLUSTER_K} and K {CLUSTER_K_SMALL}; (d) K = 1 "
        f"matches full batch; (e) host-resident within {cs['host_drift']:.2e} <= 2 x {cs['drift']:.2e}, peaks full / "
        f"device / host {cs['peaks']['full'] / 2**30:.3f} / {cs['peaks']['device'] / 2**30:.3f} / "
        f"{cs['peaks']['host'] / 2**30:.3f} GiB, copy overlap {cs['overlap']:.4f}; (f) HGT K {CLUSTER_K_HGT} peak "
        f"{cs['hgt_peak'] / 2**30:.2f} GiB; (g) bench --bf16 --clusters {CLUSTER_K} {cs['bench']:.1f} edges/s; (h) bf16 "
        f"host-resident within {cs['host_drift_bf16']:.2e} <= 2 x {cs['drift_bf16']:.2e}",
    )

    # 26. cluster-quality --------------------------------------------------
    t0 = time.perf_counter()
    quality = _cluster_quality_phase(dev)
    _phase(
        "cluster-quality", t0,
        f"R2 K=1 {quality['r2_k1']:.6f}, K=4 {quality['r2_k4']:.6f} (both >= {QUALITY_R2_MIN}, gap <= "
        f"{QUALITY_R2_GAP}); K=4 within {QUALITY_JAX_MARGIN} of the JAX CPU value {JAX_CPU_R2_K4:.6f}; K=4 in bf16 "
        f"{quality['r2_k4_bf16']:.6f} (>= {QUALITY_R2_MIN}, within {BF16_NOISE_BUDGET} of float32's)",
    )
    # 27. bf16 -------------------------------------------------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = _bf16_phase(dev, graph_cpu, graph, graph_hgt, config, hgt_config, dual_config, tiers, masker, masker0,
                       flagship_r2_f32, reset_counts, bf16_run, side_runs / "bf16")
    side_tmp.cleanup()
    rg, hg = bf16["rgcn"], bf16["hgt"]
    _phase(
        "bf16", t0,
        f"(a) probe ratio {bf16['probe']['ratio']} (min {bf16['probe']['ratio_min']}); (b) K1, K2f, K2b, K3, K4f, K4b, "
        f"K5f, K5b in bf16 match their plain versions; (c) the bf16 step matches the CPU plain step, launches "
        f"{bf16['launches_step']}; (d) state and requests within {BF16_STATE_RATIO} of bf16's own effect; (e) RGCN "
        f"epoch bf16 / f32 "
        f"{rg['RGCN bf16']['epoch_ms']:.2f} / {rg['RGCN f32']['epoch_ms']:.2f} ms (device "
        f"{rg['RGCN bf16']['device_ms']:.2f} / {rg['RGCN f32']['device_ms']:.2f}), HGT "
        f"{hg['HGT bf16']['epoch_ms']:.2f} / {hg['HGT f32']['epoch_ms']:.2f} ms, bench --bf16 "
        f"{bf16['bench']['value']:.1f} edges/s; (f) pin R2 {bf16['quality']['pin']['bfloat16']:.4f}, flagship bf16 R2 "
        f"{bf16['quality']['flagship_r2']:.4f} (f32 {flagship_r2_f32:.4f})",
    )

    # 28. ingest -------------------------------------------------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ingest = _ingest_phase(dev, reset_counts, counts_of)
    st = ingest["stages"]
    _phase(
        "ingest", t0,
        f"(a) raw CSVs {ingest['emit_s']:.2f} s; (b) scan native = plain on {ETL_SCAN_ROWS} rows (.csv, .csv.gz), "
        f"full scan {st['labevents_scan']['s']:.3f} s ({st['labevents_scan']['rows_per_sec']:.0f} rows/s); (c) "
        f"cohort {st['cohort']['s']:.3f} s, preprocess {st['preprocess']['s']:.3f} s, graph build core "
        f"{ingest['graph_build_s']['core']:.3f} / plain {ingest['graph_build_s']['plain']:.3f} s, plans equal; "
        f"(d) {ETL_EPOCHS} kernel epochs, test R2 {ingest['train']['test_r2']:.4f}; (e) eICU command line "
        f"{ingest['eicu']['s']:.2f} s",
    )

    # 29. visualize ----------------------------------------------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    visual = _visualize_phase(dev, Path(life_tmp.name) / "unbroken", life_config, hgt_state, hgt_config, graph_cpu,
                              graph, graph_hgt, graph_seg, masker, config, reset_counts, counts_of)
    life_tmp.cleanup()
    ceil, va = visual["ceiling"], visual["a"]
    _phase(
        "visualize", t0,
        f"(a) step 6 on the RGCN at scale_100k in {visual['step_s']:.2f} s, K1 / K2f / K3 launched "
        f"{visual['launches']['segment_sum_windowed']} / {visual['launches']['fused_table_segment_sum']} / "
        f"{visual['launches']['span_segment_sum']} times, left out {len(va['left_out'])} figures; the calibration "
        f"table and the PCA plane match the CPU plain path's; (b) the HGT's on the flash tier (K6 "
        f"{visual['launches_hgt']['flash_attention_fwd']}) match the segment tier's; (c) the Bayes ceiling card / "
        f"CPU {ceil['card_s']:.3f} / {ceil['cpu_s']:.3f} s within {ceil['rel']:.1e}, peak {ceil['peak_gib']:.3f} GiB, the "
        f"LMMSE ceiling R2 {ceil['lmmse_r2']:.6f} = the JAX package's; (d) diagnose_quality's yardsticks card = CPU "
        f"within {visual['diagnose']['rel']:.1e}",
    )

    cluster_launches = clusters["launches_cluster_epoch"]
    for name in ("segment_sum_windowed", "fused_table_segment_sum", "fused_table_segment_sum_bwd"):
        if not cluster_launches[name]:
            raise AssertionError(f"{name} did not launch in the K {CLUSTER_K} cluster epoch: {cluster_launches}")

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
        if name in export_launches:
            entry["launches_serving_export"] = export_launches[name]
        if name == "segment_sum_windowed":
            entry["as_span_backward"] = k1_backward
        if name in vc_launches:
            entry["launches_value_context_step"] = vc_launches[name]
        if name in vc_hgt_launches:
            entry["launches_value_context_hgt_step"] = vc_hgt_launches[name]
        entry["launches_cluster_epoch"] = cluster_launches[name]
        if name in bf16["launches_step"]:  # the kernels with a bfloat16 instantiation
            entry["launches_bf16_step"] = bf16["launches_step"][name]
            entry["bf16"] = bf16["kernels"][name]
        if any(name in sites for sites in clusters["sites"].values()):
            entry["cluster_sites"] = {
                cfg: sites[name] for cfg, sites in clusters["sites"].items() if name in sites
            }
        if any(name in sites for sites in clusters["sites_bf16"].values()):
            entry["cluster_sites_bf16"] = {
                cfg: sites[name] for cfg, sites in clusters["sites_bf16"].items() if name in sites
            }
            entry["launches_bf16_cluster_step"] = clusters["launches_bf16_cluster_step"][name]
        if name in vc_bf16_launches:
            entry["launches_value_context_bf16_step"] = vc_bf16_launches[name]
        # step 6: the RGCN's (a), the HGT's flash tier for K6-K8 (b)
        entry["launches_visualize"] = (visual["launches_hgt"] if name in visual["launches_hgt"]
                                       else visual["launches"]).get(name, 0)
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
