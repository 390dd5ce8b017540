"""The JAX package's Cluster-GCN quality pin, run on the CPU: the recipe of
``tests/test_minibatch.py::test_k_gt1_quality_on_realistic_cohort``
(``SyntheticSpec.eicu_demo()`` at seed 0 with signal 0.6, the
``embedding`` bilinear source at rank 17, MSE, 60 epochs at lr 1e-4 with no
scheduler, the side-information warm start at rank 8 and reg 12, split seed
42), each K's test R² of the best validation state.  The PyTorch port is
held to the K = 4 value on the card (``chip_smoke.py`` phase 26,
``JAX_CPU_R2_K4``).

Usage:
    python tests/jax_minibatch_quality.py [--ks 4,1]

Prints one JSON line, ``{"k4": r2, "k1": r2}``.  A script beside the tests
(pytest does not collect it): it imports the JAX package, which the port's
tools may not.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from multi_modal_gnn_tpu.utils.platform import force_cpu_devices  # noqa: E402

force_cpu_devices(8)

from multi_modal_gnn_tpu.config import Config  # noqa: E402
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec, generate_synthetic_tables  # noqa: E402
from multi_modal_gnn_tpu.evaluation.metrics import compute_regression_metrics  # noqa: E402
from multi_modal_gnn_tpu.graph.build import build_heterogeneous_graph  # noqa: E402
from multi_modal_gnn_tpu.models.factory import build_model  # noqa: E402
from multi_modal_gnn_tpu.training.masker import EdgeMasker  # noqa: E402
from multi_modal_gnn_tpu.training.minibatch import MiniBatchTrainer  # noqa: E402
from multi_modal_gnn_tpu.training.trainer import Trainer  # noqa: E402
from multi_modal_gnn_tpu.training.warmstart import (  # noqa: E402
    bundle_membership_matrix,
    warm_start_trainer,
)

EPOCHS = 60


def quality_config() -> Config:
    cfg = Config()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model,
            edge_head=dataclasses.replace(
                cfg.model.edge_head, extras={"bilinear_rank": 17, "bilinear_source": "embedding"}
            ),
        ),
        train=dataclasses.replace(
            cfg.train, loss="mse", epochs=EPOCHS, early_stopping_patience=10**9,
            optimizer=dataclasses.replace(cfg.train.optimizer, lr=1e-4),
            lr_scheduler=dataclasses.replace(cfg.train.lr_scheduler, enabled=False),
        ),
    )


def run(k: int, cfg: Config, bundle, memberships) -> float:
    masker = EdgeMasker(bundle.graph, seed=42, host_edges=bundle.patient_lab_host())
    model = build_model(cfg, bundle.graph)
    if k == 1:
        trainer = Trainer(model, bundle.graph, masker, cfg)
    else:
        trainer = MiniBatchTrainer(model, bundle, masker, cfg, num_clusters=k)
    warm_start_trainer(trainer, rank=8, reg=12.0, memberships=memberships)
    for _ in range(EPOCHS):
        trainer.train_epoch()
        val = trainer.validate()
        if val < trainer.best_val_loss:
            trainer.best_val_loss = val
            trainer.best_state = jax.tree_util.tree_map(lambda x: x.copy(), trainer.state)
        trainer.epoch += 1
    best = trainer.best_state if trainer.best_state is not None else trainer.state
    _, _, test_values = masker.split_arrays("test")
    preds = trainer.predict("test", state=best).astype(np.float64)
    return compute_regression_metrics(preds, test_values)["r2"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ks", default="4,1", help="comma-separated cluster counts (1 = full batch)")
    args = parser.parse_args(argv)
    cfg = quality_config()
    spec = dataclasses.replace(SyntheticSpec.eicu_demo(), seed=0, signal_strength=0.6)
    tables = generate_synthetic_tables(spec)
    bundle = build_heterogeneous_graph(
        labs=tables["labs_normalized"], diagnoses=tables["diagnoses"], medications=tables["medications"],
        cohort=tables["cohort"], labitems=tables["labitems"], config=cfg,
    )
    memberships = bundle_membership_matrix(bundle)
    print(json.dumps({f"k{k}": run(k, cfg, bundle, memberships) for k in map(int, args.ks.split(","))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
