"""Serving latency and throughput on the card (``scripts/bench_serving.py``,
ported).

    python -m multi_modal_gnn_tpu_torch.tools.bench_serving [--scale] [--device cuda|cpu]

Builds the cohort from its tables (``SyntheticSpec.eicu_demo()``; with
``--scale`` ``scale_100k`` with ``use_pallas: true`` and dense budget 0), an
RGCN with random weights from ``train.seed``, an ALS fit on the train split,
exports the serving artifact into a temporary directory and loads it, then
times on the host clock, each request ending in its readback:

* ``single_patient``: ``ServingModel.predict_patient`` (every lab of a random
  patient, the smallest bucket), p50 / p95 / mean over ``--requests``;
* ``eager_single_patient``: the same patients through the in-process
  ``build_serving_fn`` (eager launches, then the readback), so the graph
  replay reads against eager launches;
* ``batch_pairs_per_s``: random pairs at the largest bucket;
* ``cold_start``: ``predict_cold_start`` from 20 observed labs (host numpy);
* ``full_forward_per_request``: ``Trainer.predict_pairs`` of one patient's
  labs, a full-graph forward per request (the reference's inference path).

Prints one JSON line with the JAX script's report keys, ``device`` (the
card's name and power limit) and ``eager_single_patient``.  There is no CPU
fallback: without a card it raises, unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_tables
from multi_modal_gnn_tpu_torch.evaluation.baselines import ALSBaseline
from multi_modal_gnn_tpu_torch.graph import build_heterogeneous_graph
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT
from multi_modal_gnn_tpu_torch.models import build_model
from multi_modal_gnn_tpu_torch.serving import ServingModel, build_serving_fn, export_serving, predict_patient
from multi_modal_gnn_tpu_torch.training import Trainer, masker_from_config
from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, gpu_identity, resolve_device
from multi_modal_gnn_tpu_torch.utils.rng import stream_seed


def _percentiles(seconds) -> Dict[str, float]:
    a = np.asarray(seconds)
    return {
        "p50_ms": float(np.percentile(a, 50) * 1e3),
        "p95_ms": float(np.percentile(a, 95) * 1e3),
        "mean_ms": float(a.mean() * 1e3),
    }


def _timed(fn, args) -> list:
    """Host seconds of ``fn(*a)`` for each ``a`` of ``args``, after one
    untimed call on the first."""
    fn(*args[0])
    out = []
    for a in args:
        t0 = time.perf_counter()
        fn(*a)
        out.append(time.perf_counter() - t0)
    return out


def run_bench_serving(
    scale: bool = False, requests: int = 200, batch_requests: int = 30, device=None
) -> dict:
    """One serving bench run on ``device`` (default: the card; raises
    without one)."""
    device = resolve_device(device)
    if device.type == "cuda":
        disable_tf32()
    cfg = Config()
    spec = SyntheticSpec.eicu_demo()
    if scale:
        spec = SyntheticSpec.scale_100k()
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model, use_pallas=True),
            graph=dataclasses.replace(cfg.graph, dense_adjacency_max_bytes=0),
        )
    t0 = time.perf_counter()
    tables = generate_synthetic_tables(spec)
    bundle = build_heterogeneous_graph(
        tables["labs_normalized"], tables["diagnoses"], tables["medications"], tables["cohort"],
        tables["labitems"], cfg,
    )
    bundle = bundle.replace_graph(bundle.graph.to(device))
    graph = bundle.graph
    build_s = time.perf_counter() - t0
    masker = masker_from_config(cfg, graph)
    generator = torch.Generator().manual_seed(stream_seed(cfg.train.seed, "init"))
    trainer = Trainer(build_model(cfg, graph, device=device, generator=generator), graph, masker, cfg, device=device)
    tr_p, tr_l, tr_v = masker.split_arrays("train")
    als = ALSBaseline(graph.num_nodes(PATIENT), graph.num_nodes(LAB), rank=8).fit(tr_v, tr_p, tr_l)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        export_serving(trainer, bundle, tmp, cold_start=als)
        sync()
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = ServingModel.load(tmp, device=device)
        load_s = time.perf_counter() - t0

    num_labs, num_patients = model.manifest["num_labs"], model.manifest["num_patients"]
    rng = np.random.default_rng(0)
    patients = [(int(p),) for p in rng.integers(num_patients, size=requests)]
    single = _percentiles(_timed(model.predict_patient, patients))
    fn, _ = build_serving_fn(trainer.eval_model(), graph)
    eager = _percentiles(_timed(lambda pid: predict_patient(fn, pid, num_labs).cpu(), patients))

    big = model.buckets[-1]
    p = rng.integers(0, num_patients, size=big).astype(np.int32)
    l = rng.integers(0, num_labs, size=big).astype(np.int32)
    batch_s = float(np.mean(_timed(model.predict, [(p, l)] * batch_requests)))

    observed = {int(i): float(v) for i, v in zip(tr_l[:20], tr_v[:20])}
    cold = _percentiles(_timed(model.predict_cold_start, [(observed,)] * min(requests, 100)))

    labs_all = np.arange(num_labs, dtype=np.int32)
    full = _percentiles(_timed(
        lambda pid: trainer.predict_pairs(np.full(num_labs, pid, np.int32), labs_all),
        patients[: min(requests, 50)],
    ))
    return {
        "device": gpu_identity() if device.type == "cuda" else str(device),
        "config": "scale_100k" if scale else "eicu_demo_synthetic",
        "buckets": model.buckets,
        "graph_build_s": build_s,
        "export_s": export_s,
        "load_s": load_s,
        "single_patient": single,
        "eager_single_patient": eager,
        "batch_bucket": big,
        "batch_pairs_per_s": big / batch_s,
        "cold_start": cold,
        "full_forward_per_request": full,
        "speedup_vs_full_forward_p50": full["p50_ms"] / single["p50_ms"],
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scale", action="store_true",
                        help="scale_100k with use_pallas: true and dense budget 0")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the card (default; raises without one) or the CPU")
    parser.add_argument("--requests", type=int, default=200)
    parser.add_argument("--batch-requests", type=int, default=30)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    result = run_bench_serving(
        scale=args.scale, requests=args.requests, batch_requests=args.batch_requests,
        device=None if args.device == "cuda" else "cpu",
    )
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
