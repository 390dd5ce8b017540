"""One data-parallel train step and one validation over N ranks at tiny
shapes (the counterpart of ``__graft_entry__.dryrun_multichip``):

    python -m multi_modal_gnn_tpu_torch.tools.dryrun_dp --ranks 2 [--device cpu]

The tool starts the N ranks itself (gloo, ``parallel/launch.py``), each on
``SyntheticSpec.tiny(seed=1)`` at hidden 32: the RGCN on the segment path,
then with ``use_pallas`` on K1's per-shard plans.  On the card (the
default; it raises without one) the ranks share card ``rank %
device_count``; ``--device cpu`` runs on the CPU.  Each run's losses must be
finite and equal on every rank.  Prints one JSON line per run and exits 0.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch


def _rank(device: str) -> list:
    return [_run(device, use_pallas) for use_pallas in (False, True)]


def _run(device: str, use_pallas: bool) -> dict:
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec
    from multi_modal_gnn_tpu_torch.data.synthetic import generate_synthetic_tables
    from multi_modal_gnn_tpu_torch.graph.build import build_heterogeneous_graph
    from multi_modal_gnn_tpu_torch.ops import segment_kernels
    from multi_modal_gnn_tpu_torch.parallel.dp import DataParallelTrainer
    from multi_modal_gnn_tpu_torch.parallel.mesh import init_axis
    from multi_modal_gnn_tpu_torch.training.masker import masker_from_config
    from multi_modal_gnn_tpu_torch.utils.device import resolve_device

    torch.set_num_threads(1)
    dev = resolve_device(None if device == "cuda" else device)
    d = Config().to_dict()
    d["model"].update(hidden_dim=32, use_pallas=use_pallas)
    cfg = Config.from_dict(d)
    t = generate_synthetic_tables(SyntheticSpec.tiny(seed=1))
    bundle = build_heterogeneous_graph(
        t["labs_normalized"], t["diagnoses"], t["medications"], t["cohort"], t["labitems"], cfg
    )
    axis = init_axis(dev)
    trainer = DataParallelTrainer(
        bundle.graph, masker_from_config(cfg, bundle.graph), cfg, axis=axis, device=dev,
        host_edges=bundle.host_edges if use_pallas else None,
    )
    segment_kernels.reset_launch_counts()
    loss = trainer.train_epoch()
    val = trainer.validate("val")
    return {
        "rank": axis.rank, "ranks": axis.size, "backend": axis.backend, "device": str(dev),
        "use_pallas": use_pallas, "train_loss": loss, "val_loss": val,
        "k1_launches": segment_kernels.launch_counts["segment_sum_windowed"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    from multi_modal_gnn_tpu_torch.parallel.launch import run_ranks

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU dry run")
    per_rank = run_ranks(_rank, args.ranks, (args.device,), timeout=600)
    for out in zip(*per_rank):
        losses = {(r["train_loss"], r["val_loss"]) for r in out}
        if len(losses) != 1 or not all(math.isfinite(x) for x in next(iter(losses))):
            raise SystemExit(f"dryrun_dp: ranks disagree or diverge: {out}")
        r0 = out[0]
        print(json.dumps({
            "dryrun_dp": "ok", "ranks": r0["ranks"], "backend": r0["backend"], "use_pallas": r0["use_pallas"],
            "train_loss": r0["train_loss"], "val_loss": r0["val_loss"],
            "k1_launches_per_rank": [r["k1_launches"] for r in out],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
