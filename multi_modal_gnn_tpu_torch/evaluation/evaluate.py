"""Model evaluation (``multi_modal_gnn_tpu/evaluation/evaluate.py``):
``evaluation_results.json`` (winsorized and raw metrics, strata, baselines,
conformal coverage), ``per_lab_metrics.csv`` and ``conformal.json``, with
the JAX package's keys and layout."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.evaluation.baselines import evaluate_baselines, graph_membership_matrix
from multi_modal_gnn_tpu_torch.evaluation.conformal import calibrate_from_trainer
from multi_modal_gnn_tpu_torch.evaluation.metrics import (
    PER_LAB_COLUMNS,
    compute_per_lab_metrics,
    compute_regression_metrics,
    stratify_by_lab_frequency,
    stratify_by_patient_degree,
    winsorize_residuals,
)
from multi_modal_gnn_tpu_torch.graph.hetero import HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.utils.io import save_csv, save_json

logger = logging.getLogger(__name__)


def evaluate_model(
    trainer,
    graph: HeteroGraph,
    config: Config,
    output_dir=None,
    split: str = "test",
    use_best_state: bool = True,
) -> Dict:
    """Evaluate ``trainer``'s best state (or its live model) on a held-out
    split and write the artifacts into ``output_dir``.  ``trainer`` needs
    ``masker``, ``predict(split, state)``, ``best_state`` and ``graph``;
    with ``use_best_state=False`` also ``model``."""
    output_dir = Path(output_dir) if output_dir is not None else None
    if output_dir is not None:
        output_dir.mkdir(parents=True, exist_ok=True)
    ec = config.evaluation

    state = trainer.best_state if (use_best_state and trainer.best_state is not None) else None
    patient_idx, lab_idx, targets = trainer.masker.split_arrays(split)
    predictions = trainer.predict(split, state=state).astype(np.float64)
    raw_metrics = compute_regression_metrics(predictions, targets)

    # post-hoc per-lab winsorization (reporting only)
    sigma = ec.winsorize_sigma
    predictions_w, num_capped = winsorize_residuals(predictions, targets, lab_idx, sigma=sigma)
    logger.info(
        "Winsorized %d/%d residuals (%.2f%%) at +/-%.1f sigma",
        num_capped, len(predictions), 100 * num_capped / max(len(predictions), 1), sigma,
    )
    overall = compute_regression_metrics(predictions_w, targets)
    logger.info(
        "%s metrics: MAE %.4f | RMSE %.4f | R2 %.4f | MAPE %.1f%%",
        split, overall["mae"], overall["rmse"], overall["r2"], overall["mape"],
    )
    results: Dict = {
        "overall_metrics": overall,
        "raw_metrics": raw_metrics,
        "num_test_samples": int(len(predictions)),
        "winsorization": {"sigma": sigma, "num_capped": int(num_capped)},
    }

    if ec.per_lab_metrics:
        per_lab = compute_per_lab_metrics(predictions_w, targets, lab_idx, lab_names=graph.lab_names)
        if output_dir is not None and per_lab:
            save_csv(per_lab, output_dir / "per_lab_metrics.csv", PER_LAB_COLUMNS)

    # baselines fitted on the train split
    if ec.baselines:
        tr_p, tr_l, tr_v = trainer.masker.split_arrays("train")
        want_nn = "nearest_neighbor" in ec.baselines
        want_als = "als" in ec.baselines
        memberships = graph_membership_matrix(graph) if "sideinfo_als" in ec.baselines else None
        want_pairs = want_nn or want_als or memberships is not None
        hd = ec.extras.get("huber_delta", None)
        results["baselines"] = evaluate_baselines(
            tr_v, tr_l, targets, lab_idx, graph.num_nodes(LAB),
            train_patient_indices=tr_p if want_pairs else None,
            test_patient_indices=patient_idx if want_pairs else None,
            num_patients=graph.num_nodes(PATIENT) if want_pairs else None,
            include_nn=want_nn,
            include_als=want_als,
            memberships=memberships,
            huber_delta=float(hd) if hd is not None else None,
        )
        for name, m in results["baselines"].items():
            if m["mae"] > 0:
                improvement = (m["mae"] - overall["mae"]) / m["mae"] * 100
                logger.info("Baseline %s: MAE %.4f (model %+.1f%%)", name, m["mae"], improvement)

    # split-conformal intervals, calibrated on "cal" (or val) with the
    # parameters the reported predictions used; coverage on this split's raw
    # predictions.  evaluation.extras.conformal_alpha, falsy: none
    alpha = ec.extras.get("conformal_alpha", 0.1)
    cal_split = "cal" if getattr(trainer.masker, "has_calibration_split", False) else "val"
    if alpha and split != cal_split:
        try:
            calibrator = calibrate_from_trainer(
                trainer, alpha=float(alpha),
                state=state if state is not None else trainer.model.state_dict(),
            )
        except ValueError as e:  # calibration split too small for this alpha
            logger.warning("Conformal calibration skipped: %s", e)
        else:
            conf = calibrator.evaluate(predictions, targets, lab_idx)
            results["conformal"] = conf
            logger.info(
                "Conformal (alpha=%.2f): coverage %.3f (target %.2f), mean width %.3f",
                calibrator.alpha, conf["coverage"], conf["target_coverage"], conf["mean_width"],
            )
            if output_dir is not None:
                calibrator.save(output_dir / "conformal.json")

    stratified: Dict = {}
    if "num_labs" in ec.stratify_by:
        stratified["by_patient_degree"] = stratify_by_patient_degree(
            predictions_w, targets, patient_idx, graph.patient_lab_degree.cpu().numpy()
        )
    if "lab_frequency" in ec.stratify_by:
        stratified["by_lab_frequency"] = stratify_by_lab_frequency(
            predictions_w, targets, lab_idx, graph.edges[PATIENT_LAB].dst_count.cpu().numpy()
        )
    results["stratified_results"] = stratified

    if output_dir is not None:
        save_json(
            {
                "overall_metrics": overall,
                "num_test_samples": results["num_test_samples"],
                "stratified_results": stratified,
                "raw_metrics": raw_metrics,
                "baselines": results.get("baselines", {}),
                **({"conformal": results["conformal"]} if "conformal" in results else {}),
            },
            output_dir / "evaluation_results.json",
        )
    return results


def evaluation_pipeline(
    config: Config, graph: HeteroGraph, checkpoint_path, output_dir, force: bool = False, device=None
) -> Dict:
    """Rebuild the model, restore a checkpoint (the port's or the JAX
    package's; its ``model_hash`` must match unless ``force``) and evaluate
    the test split.  The splits come from :func:`masker_from_config`, as
    training drew them."""
    from multi_modal_gnn_tpu_torch.models.factory import build_model
    from multi_modal_gnn_tpu_torch.training.masker import masker_from_config
    from multi_modal_gnn_tpu_torch.training.trainer import Trainer

    masker = masker_from_config(config, graph)
    model = build_model(config, graph, device=device)
    trainer = Trainer(model, graph, masker, config, device=device)
    trainer.restore(checkpoint_path, force=force)
    return evaluate_model(trainer, graph, config, output_dir=output_dir)
