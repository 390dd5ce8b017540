"""Leakage audit and robust metrics (``multi_modal_gnn_tpu/audit.py``).

* patient-overlap accounting across the edge-level splits (overlap is
  expected and valid there; the audit documents it);
* masked-value visibility: no node features, only patient->lab edges carry
  values, the splits partition the edges, supervision on train only;
* :class:`PatientHoldoutSplitter`, a whole-patient split the trainer can
  take in place of the edge masker;
* SMAPE / WAPE and percentile-winsorized metrics;
* :func:`run_full_audit`, which writes ``audit_report.json``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.build import GraphBundle
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker, masker_from_config
from multi_modal_gnn_tpu_torch.utils.io import save_json
from multi_modal_gnn_tpu_torch.utils.rng import stream_seed

logger = logging.getLogger(__name__)


def audit_patient_leakage(masker) -> Dict:
    """Patient-overlap accounting for the edge-level splits."""
    patients = {
        split: set(masker.split_arrays(split)[0].tolist()) for split in ("train", "val", "test")
    }
    tr, va, te = patients["train"], patients["val"], patients["test"]
    return {
        "split_type": "edge_level",
        "num_train_patients": len(tr),
        "num_val_patients": len(va),
        "num_test_patients": len(te),
        "train_val_overlap": len(tr & va),
        "train_test_overlap": len(tr & te),
        "val_test_overlap": len(va & te),
        "all_splits_overlap": len(tr & va & te),
        "total_unique_patients": len(tr | va | te),
        "note": "Edge-level splits: patient overlap across splits is expected and valid",
    }


def audit_masked_value_visibility(graph: HeteroGraph, masker) -> Dict:
    """Checks that held-out values cannot reach the model through node
    features, other relations or the supervision."""
    report: Dict = {
        # nodes are pure ID spaces; embeddings are learned
        "masked_values_in_node_features": False,
        "node_feature_leak_details": "nodes carry no features; ID embeddings only",
    }
    attr_relations = ["__".join(et) for et, es in graph.edges.items() if es.val is not None]
    report["edge_attr_relations"] = attr_relations
    report["masked_values_in_other_edges"] = attr_relations != ["__".join(PATIENT_LAB)]
    # the splits (with the conformal "cal" split) must partition the edges
    idx = {s: masker.split_indices(s) for s in masker.split_sizes()}
    union = np.concatenate(list(idx.values()))
    overlap = len(union) != len(np.unique(union))
    exhaustive = len(np.unique(union)) == masker.num_edges
    report["supervision_leak"] = bool(overlap)
    report["splits_exhaustive"] = bool(exhaustive)
    report["supervision_leak_details"] = (
        "train/val/test splits are mutually exclusive and exhaustive"
        if not overlap and exhaustive
        else "SPLIT OVERLAP DETECTED"
    )
    # the supervision mask is drawn over the train batch only
    train = set(idx["train"].tolist())
    report["train_only_supervision"] = all(
        train.isdisjoint(v.tolist()) for s, v in idx.items() if s != "train"
    )
    return report


class PatientHoldoutSplitter(EdgeMasker):
    """Whole-patient holdout: each patient's lab edges all land in one
    split.  An :class:`EdgeMasker` (row-major batches, the same supervision
    draws) whose splits are drawn over patients, as JAX draws them."""

    def __init__(
        self,
        graph: HeteroGraph,
        train_split: float = 0.7,
        val_split: float = 0.15,
        test_split: float = 0.15,
        seed: int = 42,
        host_edges: Optional[tuple] = None,
        pad_multiple: int = 256,
        mask_fraction: float = 0.2,
    ):
        if host_edges is not None:
            src, dst, val = host_edges
        else:
            es = graph.edges[PATIENT_LAB]
            keep = es.mask.cpu().numpy() > 0
            src, dst, val = (t.cpu().numpy()[keep] for t in (es.src, es.dst, es.val))
        self._p = np.asarray(src, dtype=np.int32)
        self._l = np.asarray(dst, dtype=np.int32)
        self._v = np.asarray(val, dtype=np.float32)
        self.num_edges = len(self._p)
        self._num_patients = graph.num_nodes(PATIENT)
        self._num_labs = graph.num_nodes(LAB)
        self.mask_fraction = float(mask_fraction)
        self.seed = int(seed)
        self.pad_multiple = int(pad_multiple)
        self.slot_major_train = False
        self.slot_major_min_rows = 0
        self.lab_block_rows = 0
        self.calibration_split = 0.0

        unique_patients = np.unique(self._p)
        perm = np.random.default_rng(seed).permutation(len(unique_patients))
        n_train = int(train_split * len(unique_patients))
        n_val = int(val_split * len(unique_patients))
        self.train_patients = set(unique_patients[perm[:n_train]].tolist())
        self.val_patients = set(unique_patients[perm[n_train : n_train + n_val]].tolist())
        self.test_patients = set(unique_patients[perm[n_train + n_val :]].tolist())
        assert not (self.train_patients & self.val_patients)
        assert not (self.train_patients & self.test_patients)
        assert not (self.val_patients & self.test_patients)
        self._split_indices = {
            split: np.where(np.isin(self._p, list(members)))[0]
            for split, members in (
                ("train", self.train_patients), ("val", self.val_patients), ("test", self.test_patients),
            )
        }
        self._batches = {}
        self._row_slots = {}
        logger.info(
            "Patient-holdout splits: %d/%d/%d patients, %d/%d/%d edges",
            len(self.train_patients), len(self.val_patients), len(self.test_patients),
            *(len(self._split_indices[s]) for s in ("train", "val", "test")),
        )


def compute_robust_metrics(y_true: np.ndarray, y_pred: np.ndarray, winsorize_pct: float = 5.0) -> Dict:
    """MAE / RMSE / R² with SMAPE, WAPE and percentile-winsorized variants."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    residuals = y_pred - y_true
    abs_res = np.abs(residuals)
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum())
    lower = np.percentile(abs_res, winsorize_pct)
    upper = np.percentile(abs_res, 100 - winsorize_pct)
    out_of_band = (abs_res < lower) | (abs_res > upper)
    return {
        "mae": float(abs_res.mean()),
        "rmse": float(np.sqrt((residuals**2).mean())),
        "r2": float(1 - (residuals**2).sum() / ss_tot) if ss_tot > 0 else 0.0,
        "smape": float(100 * np.mean(abs_res / (np.abs(y_true) + np.abs(y_pred) + 1e-8))),
        "wape": float(100 * abs_res.sum() / (np.abs(y_true).sum() + 1e-8)),
        "mae_winsorized": float(np.clip(abs_res, lower, upper).mean()),
        "rmse_winsorized": float(np.sqrt((np.clip(residuals, -upper, upper) ** 2).mean())),
        "winsorize_percentile": winsorize_pct,
        "num_outliers_capped": int(out_of_band.sum()),
        "outlier_percentage": float(100 * out_of_band.mean()),
        "max_residual": float(abs_res.max()),
        "p95_residual": float(np.percentile(abs_res, 95)),
    }


def run_full_audit(
    config: Config,
    bundle: GraphBundle,
    trainer=None,
    output_dir=None,
    compare_holdout: bool = False,
) -> Dict:
    """Split hygiene, visibility checks and, given a trainer, robust metrics
    of its best state on the test split; with ``compare_holdout`` a second
    model is trained on a whole-patient holdout (``config.train``'s splits,
    seed and mask fraction) and compared.  Writes ``audit_report.json``
    into ``output_dir``."""
    graph = bundle.graph
    masker = trainer.masker if trainer is not None else masker_from_config(config, graph)
    report: Dict = {
        "patient_leakage": audit_patient_leakage(masker),
        "masked_value_visibility": audit_masked_value_visibility(graph, masker),
    }
    if trainer is not None:
        _, _, y_true = masker.split_arrays("test")
        y_pred = trainer.predict("test", state=trainer.best_state)
        report["robust_metrics_edge_level"] = compute_robust_metrics(y_true, y_pred)

    if compare_holdout and trainer is not None:
        from multi_modal_gnn_tpu_torch.models.factory import build_model
        from multi_modal_gnn_tpu_torch.training.trainer import Trainer

        tc = config.train
        holdout = PatientHoldoutSplitter(
            graph, train_split=tc.train_split, val_split=tc.val_split, test_split=tc.test_split,
            seed=tc.seed, host_edges=bundle.patient_lab_host(), mask_fraction=tc.mask_fraction,
        )
        generator = torch.Generator().manual_seed(stream_seed(tc.seed, "init"))
        model = build_model(config, graph, device=trainer.device, generator=generator)
        h_trainer = Trainer(model, graph, holdout, config, device=trainer.device)
        h_trainer.fit()
        _, _, y_true = holdout.split_arrays("test")
        y_pred = h_trainer.predict("test", state=h_trainer.best_state)
        report["split_strategy_comparison"] = {
            "edge_level": report.get("robust_metrics_edge_level"),
            "patient_holdout": compute_robust_metrics(y_true, y_pred),
            "note": "patient holdout is the harder task; lower metrics expected",
        }

    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        save_json(report, output_dir / "audit_report.json")
        logger.info("Audit report written to %s", output_dir / "audit_report.json")
    return report
