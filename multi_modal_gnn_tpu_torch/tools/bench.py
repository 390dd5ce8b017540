"""Training-throughput benchmark on the card (the repo root's ``bench.py``,
ported).

Metric: patient-lab train edges per second of training, sustained over
timed epochs after a warm-up: full batch, or ``--clusters N`` host-resident
Cluster-GCN clusters (``training/minibatch.py``), as the JAX bench runs
them.  The warm-up is one chunk of
``Trainer.train_epochs``; the timed chunks run back to back with no host
readback, one ``torch.cuda.synchronize`` at the end, and the losses are read
once.  Prints ONE JSON line with the JAX bench's keys:
``{"metric", "value", "unit", "vs_baseline", ...}``; ``device`` is the
card's name and power limit, ``aggregation_impl`` the aggregation tiers the
model's relations (RGCN) or attention groups (HGT) take, and
``kernel_launches`` the hand-written kernels' launches in the timed chunks;
with ``--clusters`` the line also has ``clusters`` and the tiers are the
cluster graphs'.

    python -m multi_modal_gnn_tpu_torch.tools.bench --scale --no-dense [--arch hgt | --mimic | --lab-tile-rows 0 | --clusters 8]

There is no CPU fallback: without a card, or on any failure, it prints the
traceback and exits non-zero with no JSON line.  ``--bf16`` raises
``ConfigError`` (bfloat16 is not ported), as do ``--lab-tile-mode block``
and ``--clusters`` below 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from multi_modal_gnn_tpu_torch.config import Config, ConfigError
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
from multi_modal_gnn_tpu_torch.graph.schema import mirror_edge_type
from multi_modal_gnn_tpu_torch.models import build_model
from multi_modal_gnn_tpu_torch.ops import attention_kernels, pairhead_kernels, segment_kernels
from multi_modal_gnn_tpu_torch.ops.segment import aggregation_tier
from multi_modal_gnn_tpu_torch.training import Trainer, masker_from_config
from multi_modal_gnn_tpu_torch.training.masker import resolve_lab_tile_rows
from multi_modal_gnn_tpu_torch.training.minibatch import MiniBatchTrainer
from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, gpu_identity, resolve_device
from multi_modal_gnn_tpu_torch.utils.rng import stream_seed

REFERENCE_EDGES_PER_SEC = 71_700.0  # the reference's CPU run: ~43k train edges x 100 epochs / ~60 s
_COUNTERS = (segment_kernels.launch_counts, pairhead_kernels.launch_counts, attention_kernels.launch_counts)


def _launch_totals() -> Dict[str, int]:
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def _aggregation_impl(model, graph, config: Config) -> str:
    """The tiers the model aggregates with, as ``+``-joined sorted names."""
    if config.model.architecture == "HGT":
        tiers = {model.hgt_0.tier(graph, dst_t) for dst_t in model.hgt_0.groups()}
    else:
        impl = "pallas" if config.model.use_pallas else "xla"
        tiers = {
            aggregation_tier(es, graph.edges.get(mirror_edge_type(et)), config.model.hidden_dim,
                             config.model.aggregation, impl)
            for et, es in graph.edges.items()
        }
    return "+".join(sorted(tiers))


def run_bench(
    scale: bool = False,
    mimic: bool = False,
    quick: bool = False,
    epochs: Optional[int] = None,
    use_pallas: Optional[bool] = None,
    dense: bool = True,
    bf16: bool = False,
    lab_tile_rows: Optional[int] = None,
    lab_tile_mode: str = "span",
    src_span_rows: Optional[int] = None,
    arch: str = "RGCN",
    clusters: int = 1,
    hgt_dense_bytes: Optional[int] = None,
    device=None,
) -> dict:
    """One bench run on ``device`` (default: the card; raises without one).
    ``use_pallas`` None takes the kernel path."""
    device = resolve_device(device)
    if clusters < 1:
        raise ConfigError(f"--clusters must be >= 1, got {clusters}")
    if bf16:
        raise ConfigError("--bf16: the port runs float32 only")
    if use_pallas is None:
        use_pallas = True
    if device.type == "cuda":
        disable_tf32()

    cfg = Config()
    extras = {"hgt_dense_attn_bytes": int(hgt_dense_bytes)} if hgt_dense_bytes is not None else {}
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, architecture=arch.upper(), use_pallas=use_pallas, extras=extras),
    )
    if not dense:
        cfg = dataclasses.replace(cfg, graph=dataclasses.replace(cfg.graph, dense_adjacency_max_bytes=0))
    if src_span_rows is not None:
        cfg = dataclasses.replace(cfg, graph=dataclasses.replace(cfg.graph, src_span_rows=src_span_rows))
    if mimic:
        spec = SyntheticSpec.mimic_scale()
        scale = True  # the scale config's epoch counts and chunk sizes
    else:
        spec = SyntheticSpec.scale_100k() if scale else SyntheticSpec.eicu_demo()
    if lab_tile_rows is None:
        lab_tile_rows = resolve_lab_tile_rows(None, spec.num_labs, use_pallas)
    cfg = dataclasses.replace(
        cfg,
        train=dataclasses.replace(
            cfg.train, extras={"lab_tile_rows": lab_tile_rows, "lab_tile_mode": lab_tile_mode}
        ),
    )
    if lab_tile_rows:  # narrow lab tiles want frequency-numbered labs
        cfg = dataclasses.replace(cfg, graph=dataclasses.replace(cfg.graph, cluster_labs_by_frequency=True))

    t0 = time.perf_counter()
    graph = ensure_attn_plans(make_synthetic_graph(spec, cfg, device=device), cfg)
    build_s = time.perf_counter() - t0

    masker = masker_from_config(cfg, graph)
    n_train = masker.split_sizes()["train"]
    generator = torch.Generator().manual_seed(stream_seed(cfg.train.seed, "init"))
    model = build_model(cfg, graph, device=device, generator=generator)
    if clusters > 1:
        trainer = MiniBatchTrainer(model, graph, masker, cfg, num_clusters=clusters, host_resident=True, device=device)
        tier_graph = trainer._ensure_clusters().subgraphs[0]
    else:
        trainer = Trainer(model, graph, masker, cfg, device=device)
        tier_graph = trainer.graph

    n_epochs = epochs or (10 if quick else (30 if scale else 300))
    chunk = min(10 if (quick or scale) else 50, n_epochs)
    n_chunks = max(n_epochs // chunk, 1)
    n_epochs = n_chunks * chunk
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    t0 = time.perf_counter()
    trainer.train_epochs(chunk, as_numpy=False)
    sync()
    warmup_s = time.perf_counter() - t0

    before = _launch_totals()
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        losses, _ = trainer.train_epochs(chunk, as_numpy=False)
    sync()
    elapsed = time.perf_counter() - t0
    launches = {name: n - before[name] for name, n in _launch_totals().items() if n > before[name]}
    last_loss = float(losses[-1])

    edges_per_sec = n_train * n_epochs / elapsed
    return {
        "metric": "train_patient_lab_edges_per_sec",
        "value": edges_per_sec,
        "unit": "edges/s",
        "vs_baseline": edges_per_sec / REFERENCE_EDGES_PER_SEC,
        "config": "mimic_scale" if mimic else "scale_100k" if scale else "eicu_demo_synthetic",
        "arch": cfg.model.architecture,
        **({"clusters": trainer.num_clusters} if clusters > 1 else {}),
        "aggregation_impl": _aggregation_impl(trainer.model, tier_graph, cfg),
        "compute_dtype": cfg.model.compute_dtype,
        "lab_tile_rows": lab_tile_rows,
        "device": gpu_identity() if device.type == "cuda" else str(device),
        "train_edges": n_train,
        "timed_epochs": n_epochs,
        "epoch_time_ms": 1000 * elapsed / n_epochs,
        "warmup_s": warmup_s,
        "graph_build_s": build_s,
        "params": sum(p.numel() for p in trainer.model.parameters()),
        "final_train_loss": last_loss,
        "kernel_launches": launches,
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scale", action="store_true", help="100k-patient scale config")
    parser.add_argument("--mimic", action="store_true",
                        help="MIMIC-III-shaped config (46k patients, 720 labs, ~5.5M edges)")
    parser.add_argument("--quick", action="store_true", help="fewer timed epochs")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--pallas", dest="pallas", action="store_true", default=None,
                        help="the hand-written kernel tiers (the default)")
    parser.add_argument("--no-pallas", dest="pallas", action="store_false",
                        help="plain PyTorch aggregation (the xla tier)")
    parser.add_argument("--no-dense", dest="dense", action="store_false", default=True,
                        help="disable the dense-adjacency tier (bench the windowed kernels)")
    parser.add_argument("--bf16", action="store_true", help="refused: the port is float32 only")
    parser.add_argument("--lab-tile-rows", type=int, default=None,
                        help="narrow lab tiles in the pair-head kernels (0=off; unset=auto: "
                             "256-row span tiles at >=512 padded labs)")
    parser.add_argument("--lab-tile-mode", type=str, default="span", choices=["block", "span"],
                        help="span only: block is refused")
    parser.add_argument("--arch", type=str, default="RGCN", choices=["RGCN", "HGT", "rgcn", "hgt"],
                        help="model architecture")
    parser.add_argument("--hgt-dense-bytes", type=int, default=None,
                        help="HGT dense-attention budget (model.extras.hgt_dense_attn_bytes; "
                             "0 forces the flash or segment tier)")
    parser.add_argument("--clusters", type=int, default=1,
                        help="mini-batch patient clusters (>1: host-resident Cluster-GCN training)")
    parser.add_argument("--src-span-rows", type=int, default=None,
                        help="span plan block height (graph.src_span_rows; unset=256)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    result = run_bench(
        scale=args.scale, mimic=args.mimic, quick=args.quick, epochs=args.epochs,
        use_pallas=args.pallas, dense=args.dense, bf16=args.bf16,
        lab_tile_rows=args.lab_tile_rows, lab_tile_mode=args.lab_tile_mode,
        src_span_rows=args.src_span_rows, arch=args.arch,
        clusters=args.clusters, hgt_dense_bytes=args.hgt_dense_bytes,
    )
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
