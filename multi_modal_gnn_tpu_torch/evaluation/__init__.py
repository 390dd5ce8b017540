"""Evaluation: metrics, winsorization, strata, baselines, conformal
intervals, the synthetic generators' performance ceilings and the
evaluation stage."""

from multi_modal_gnn_tpu_torch.evaluation.baselines import (
    ALSBaseline,
    GlobalMeanBaseline,
    NearestNeighborBaseline,
    PerLabMeanBaseline,
    SideInfoALSBaseline,
    evaluate_baselines,
    graph_membership_matrix,
    membership_matrix,
)
from multi_modal_gnn_tpu_torch.evaluation.ceiling import (
    crossfit_oracle_ceiling,
    gaussian_conditional_ceiling,
    gaussian_posterior_means,
    lmmse_conditional_ceiling,
)
from multi_modal_gnn_tpu_torch.evaluation.conformal import (
    ConformalCalibrator,
    calibrate_cold_start,
    calibrate_from_trainer,
    conformal_quantile,
)
from multi_modal_gnn_tpu_torch.evaluation.evaluate import evaluate_model, evaluation_pipeline
from multi_modal_gnn_tpu_torch.evaluation.metrics import (
    compute_per_lab_metrics,
    compute_regression_metrics,
    stratify_by_lab_frequency,
    stratify_by_patient_degree,
    winsorize_residuals,
)

__all__ = [
    "ALSBaseline", "ConformalCalibrator", "GlobalMeanBaseline", "NearestNeighborBaseline",
    "PerLabMeanBaseline", "SideInfoALSBaseline", "calibrate_cold_start", "calibrate_from_trainer",
    "compute_per_lab_metrics", "compute_regression_metrics", "conformal_quantile",
    "crossfit_oracle_ceiling", "evaluate_baselines", "evaluate_model", "evaluation_pipeline",
    "gaussian_conditional_ceiling", "gaussian_posterior_means", "graph_membership_matrix",
    "lmmse_conditional_ceiling", "membership_matrix", "stratify_by_lab_frequency",
    "stratify_by_patient_degree", "winsorize_residuals",
]
