"""Regression metrics, per-lab breakdowns, winsorization and stratification
(``multi_modal_gnn_tpu/evaluation/metrics.py``), in numpy.

* MAE / RMSE / R^2 / MAPE on non-zero targets;
* the per-lab table (labs with at least 2 samples, sorted by MAE), as a list
  of row dicts in place of the JAX package's DataFrame;
* post-hoc per-lab residual winsorization at mean +/- k sigma;
* strata by patient lab-degree (1-5 / 6-15 / 16+) and by the quartiles of
  the positive lab counts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

PER_LAB_COLUMNS = ("mae", "rmse", "r2", "mape", "lab_index", "lab_name", "num_samples")


def compute_regression_metrics(predictions: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
    predictions = np.asarray(predictions, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    err = predictions - targets
    mae = float(np.mean(np.abs(err)))
    rmse = float(np.sqrt(np.mean(err**2)))
    ss_res = float(np.sum(err**2))
    ss_tot = float(np.sum((targets - targets.mean()) ** 2))
    r2 = float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0
    nz = targets != 0
    mape = (
        float(np.mean(np.abs((targets[nz] - predictions[nz]) / targets[nz])) * 100)
        if nz.any()
        else float("nan")
    )
    return {"mae": mae, "rmse": rmse, "r2": r2, "mape": mape}


def winsorize_residuals(
    predictions: np.ndarray,
    targets: np.ndarray,
    lab_indices: np.ndarray,
    sigma: float = 3.0,
) -> Tuple[np.ndarray, int]:
    """Cap residuals per lab at mean +/- sigma * std; returns (adjusted
    predictions, number capped).  For reporting only."""
    predictions = np.asarray(predictions, dtype=np.float64).copy()
    targets = np.asarray(targets, dtype=np.float64)
    lab_indices = np.asarray(lab_indices)
    residuals = predictions - targets
    num_capped = 0
    for lab_idx in np.unique(lab_indices):
        m = lab_indices == lab_idx
        r = residuals[m]
        if len(r) > 1:
            mu, sd = r.mean(), r.std()
            capped = np.clip(r, mu - sigma * sd, mu + sigma * sd)
            num_capped += int(np.sum(capped != r))
            predictions[m] = targets[m] + capped
    return predictions, num_capped


def compute_per_lab_metrics(
    predictions: np.ndarray,
    targets: np.ndarray,
    lab_indices: np.ndarray,
    lab_names: Optional[Dict[int, str]] = None,
    min_samples: int = 2,
) -> List[Dict]:
    """One row per lab with at least ``min_samples`` samples, keyed by
    :data:`PER_LAB_COLUMNS`, sorted by MAE as the JAX table is."""
    lab_names = lab_names or {}
    rows = []
    for lab_idx in np.unique(lab_indices):
        m = lab_indices == lab_idx
        if int(m.sum()) < min_samples:
            continue
        metrics = compute_regression_metrics(predictions[m], targets[m])
        metrics["lab_index"] = int(lab_idx)
        metrics["lab_name"] = lab_names.get(int(lab_idx), f"Lab_{int(lab_idx)}")
        metrics["num_samples"] = int(m.sum())
        rows.append(metrics)
    # the order of pandas' sort_values (numpy's quicksort)
    order = np.argsort(np.array([r["mae"] for r in rows]), kind="quicksort")
    return [rows[i] for i in order]


def stratify_by_patient_degree(
    predictions: np.ndarray,
    targets: np.ndarray,
    patient_indices: np.ndarray,
    patient_lab_degree: np.ndarray,
) -> Dict[str, Dict]:
    deg = np.asarray(patient_lab_degree)[np.asarray(patient_indices)]
    groups = {
        "low (1-5 labs)": (deg >= 1) & (deg <= 5),
        "medium (6-15 labs)": (deg >= 6) & (deg <= 15),
        "high (16+ labs)": deg >= 16,
    }
    out = {}
    for name, m in groups.items():
        if m.sum() > 0:
            metrics = compute_regression_metrics(predictions[m], targets[m])
            metrics["num_samples"] = int(m.sum())
            out[name] = metrics
    return out


def stratify_by_lab_frequency(
    predictions: np.ndarray,
    targets: np.ndarray,
    lab_indices: np.ndarray,
    lab_counts: np.ndarray,
) -> Dict[str, Dict]:
    lab_counts = np.asarray(lab_counts)
    freq = lab_counts[np.asarray(lab_indices)]
    positive = lab_counts[lab_counts > 0]
    if len(positive) == 0:
        return {}
    q25 = np.percentile(positive, 25)
    q75 = np.percentile(positive, 75)
    groups = {
        "rare (bottom 25%)": freq < q25,
        "common (middle 50%)": (freq >= q25) & (freq <= q75),
        "very common (top 25%)": freq > q75,
    }
    out = {}
    for name, m in groups.items():
        if m.sum() > 0:
            metrics = compute_regression_metrics(predictions[m], targets[m])
            metrics["num_samples"] = int(m.sum())
            out[name] = metrics
    return out
