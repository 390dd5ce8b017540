"""How far Cluster-GCN runs from one init drift apart on the card, by where
the clusters live: device-resident against host-resident (copied on a side
stream, ``training/minibatch.py``).

    python -m multi_modal_gnn_tpu_torch.tools.cluster_drift [--runs 10] [--clusters 8] [--epochs 3]
        [--dtype float32 | bfloat16]

On the ``scale_100k`` graph (``chip_smoke.py`` phase 3's config: dense
budget 0, span rows 256, ``use_pallas``, hidden 128), one K-cluster
edge-balanced partition is built once and shared; each run is a fresh
``MiniBatchTrainer`` on the same seeded weights (seed 4), ``--runs`` runs of
each mode in turns (device, host, device, ...), ``--epochs`` epochs with a
validation loss each.  A run's drift is :func:`rel_drift` against the first
device-resident run: the largest relative difference over its train and
validation losses.  The kernels' atomics change the order of sums from run
to run, so runs of one mode differ too; if host-resident runs drift further
than device-resident ones do among themselves, the copy path is at fault.
Prints one line per run and one JSON line (each mode's drifts, their
median and largest, and the card).
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Dict, List, Optional, Sequence

import torch

from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, gpu_identity, require_cuda

MODES = ("device", "host")


def rel_drift(a: Dict[str, List[float]], b: Dict[str, List[float]]) -> float:
    """The largest relative difference of ``a``'s train and validation losses
    from ``b``'s, epoch by epoch."""
    return max(abs(x - y) / abs(y) for key in ("train", "val") for x, y in zip(a[key], b[key]))


def resident_runs(make: Callable[[bool], object], runs: int, epochs: int) -> Dict[str, List[Dict]]:
    """``runs`` runs of each mode in turns; ``make(host_resident)`` gives a
    fresh trainer on the same weights.  Each run: its losses and drift
    against the first device-resident run."""
    out = {mode: [] for mode in MODES}
    for _ in range(runs):
        for mode in MODES:
            trainer = make(mode == "host")
            train, val = trainer.train_epochs(epochs, with_val=True)
            out[mode].append({"train": [float(x) for x in train], "val": [float(x) for x in val]})
            del trainer
    first = out["device"][0]
    for mode in MODES:
        for run in out[mode]:
            run["drift"] = rel_drift(run, first)
    return out


def summary(sample: Dict[str, List[Dict]]) -> Dict[str, Dict]:
    """Each mode's drifts (the first device-resident run, 0 against itself,
    left out), their median and largest."""
    out = {}
    for mode, runs in sample.items():
        drifts = [r["drift"] for r in (runs[1:] if mode == "device" else runs)]
        out[mode] = {"drifts": drifts, "median": statistics.median(drifts), "max": max(drifts)}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=10, help="runs of each mode")
    parser.add_argument("--clusters", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = parser.parse_args(argv)

    from multi_modal_gnn_tpu_torch.config import Config, GraphConfig, ModelConfig
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
    from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, GraphMeta, host_edges_of
    from multi_modal_gnn_tpu_torch.graph.schema import LAB
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.models.losses import compute_lab_weights
    from multi_modal_gnn_tpu_torch.training import MiniBatchTrainer, masker_from_config
    from multi_modal_gnn_tpu_torch.training.minibatch import build_patient_clusters

    dev = require_cuda()
    disable_tf32()
    config = Config(
        graph=GraphConfig(dense_adjacency_max_bytes=0, src_span_rows=256),
        model=ModelConfig(use_pallas=True, compute_dtype=args.dtype),
    )
    graph_cpu = make_synthetic_graph(SyntheticSpec.scale_100k(seed=0), config, device="cpu")
    graph = graph_cpu.to(dev)
    masker = masker_from_config(config, graph_cpu)
    bundle = GraphBundle(graph=graph_cpu, meta=GraphMeta(), host_edges=host_edges_of(graph_cpu))
    _, tr_l, tr_v = masker.split_arrays("train")
    lab_w = compute_lab_weights(tr_v, tr_l, graph_cpu.num_nodes(LAB))
    clusters = build_patient_clusters(bundle, masker, config, args.clusters, lab_weights=lab_w)
    on_card = GraphBundle(graph=graph, meta=GraphMeta(), host_edges=bundle.host_edges)

    def make(host: bool):
        model = build_model(config, graph_cpu, generator=torch.Generator().manual_seed(4))
        return MiniBatchTrainer(model, on_card, masker, config, args.clusters, host_resident=host, clusters=clusters)

    sample = resident_runs(make, args.runs, args.epochs)
    for mode in MODES:
        for i, run in enumerate(sample[mode]):
            print(f"{mode}-resident {i + 1}: drift {run['drift']:.3e}  train {run['train']}  val {run['val']}")
    result = {
        "clusters": args.clusters, "epochs": args.epochs, "runs": args.runs, "dtype": args.dtype,
        **summary(sample), "device_identity": gpu_identity(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
