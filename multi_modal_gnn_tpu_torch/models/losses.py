"""Regression losses and lab-wise inverse-variance reweighting
(``multi_modal_gnn_tpu/models/losses.py``).

* per-sample mae / mse / huber (delta 1);
* the supervision-masked, lab-weighted mean over the supervised subset;
* lab weights ``1 / (Var(lab) + 1e-6)`` from the train split (unbiased
  variance, 1.0 for labs with fewer than 2 samples), normalised to mean 1.
"""

from __future__ import annotations

import numpy as np
import torch


def per_sample_loss(predictions: torch.Tensor, targets: torch.Tensor, loss_type: str) -> torch.Tensor:
    err = predictions - targets
    if loss_type == "mae":
        return err.abs()
    if loss_type == "mse":
        return err * err
    if loss_type == "huber":
        abs_err = err.abs()
        return torch.where(abs_err <= 1.0, 0.5 * err * err, abs_err - 0.5)
    raise ValueError(f"Unknown loss type: {loss_type}")


def weighted_regression_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    sample_weights: torch.Tensor,
    supervision_mask: torch.Tensor,
    loss_type: str = "mae",
) -> torch.Tensor:
    """``sum(loss * w * m) / max(sum(m), 1)``: the mask joins the epoch's
    supervision draw with the padding validity."""
    losses = per_sample_loss(predictions, targets, loss_type)
    num = (losses * sample_weights * supervision_mask).sum()
    return num / supervision_mask.sum().clamp_min(1.0)


def masked_mean_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    valid_mask: torch.Tensor,
    loss_type: str = "mae",
) -> torch.Tensor:
    """Unweighted masked mean (validation and test loss)."""
    losses = per_sample_loss(predictions, targets, loss_type)
    return (losses * valid_mask).sum() / valid_mask.sum().clamp_min(1.0)


def compute_lab_weights(
    train_values: np.ndarray, train_lab_indices: np.ndarray, num_labs: int
) -> np.ndarray:
    """Inverse-variance lab weights from the train split (host-side, once)."""
    variances = np.ones(num_labs, dtype=np.float64)
    for lab_idx in range(num_labs):
        vals = train_values[train_lab_indices == lab_idx]
        if len(vals) > 1:
            variances[lab_idx] = vals.var(ddof=1)
    weights = 1.0 / (variances + 1e-6)
    weights = weights * num_labs / weights.sum()
    return weights.astype(np.float32)
