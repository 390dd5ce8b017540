"""Performance ceilings of the synthetic generators
(``multi_modal_gnn_tpu/evaluation/ceiling.py``), in float64 on a device.

The flat cohort draws normalized lab values from a jointly Gaussian
low-rank model,

    z_p ~ N(0, I_k),   v(p, l) = s <w_l, z_p> + sigma eps,   sigma^2 = 1 - s^2,

so the Bayes-optimal prediction of a held-out value from a patient's
observed (train split) values is the Gaussian posterior over ``z_p``:

    A_p  = I_k + (s^2 / sigma^2) W_O^T W_O       (posterior precision)
    mu_p = A_p^-1 (s / sigma^2) W_O^T v_O        (posterior mean)
    yhat = s <w_l, mu_p>,   E[(y - yhat)^2] = s^2 w_l^T A_p^-1 w_l + sigma^2

:func:`gaussian_conditional_ceiling` gives its expected and realized
metrics; :func:`crossfit_oracle_ceiling` the empirical ceiling of any
patient features (labs posterior plus dx / rx memberships); and
:func:`lmmse_conditional_ceiling` the heteroscedastic linear ceiling of the
eicu generator's effective model (``SyntheticLatents.w_eff`` /
``noise_var`` / ``mean_shift``).

Each precision matrix is the sum of its edges' outer products, added with
``index_add_`` in chunks of :data:`EDGE_CHUNK` edges (3.5M train edges of
``scale_100k`` hold 1.8 GB of 8 x 8 products), and solved by a batched
Cholesky factorization; the cross-fit's ridge systems by
``torch.linalg.solve``.  Inputs are numpy arrays or tensors; ``device``
defaults to the card (pass ``device="cpu"`` for the CPU); the returned
dicts hold JAX's keys, with numpy predictions and the regression metrics
of :mod:`~multi_modal_gnn_tpu_torch.evaluation.metrics`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.evaluation.metrics import compute_regression_metrics
from multi_modal_gnn_tpu_torch.utils.device import resolve_device

# edges whose [chunk, k, k] outer products are formed at once
EDGE_CHUNK = 1 << 20


def _f64(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _index(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def _accumulate(
    precision: torch.Tensor,
    rhs: torch.Tensor,
    w_obs: torch.Tensor,
    patient: torch.Tensor,
    outer_weight: torch.Tensor,
    rhs_weight: torch.Tensor,
) -> None:
    """``precision[p] += sum_e outer_weight_e w_e w_e^T`` and ``rhs[p] +=
    sum_e rhs_weight_e w_e`` over each patient's edges, in place."""
    for start in range(0, len(patient), EDGE_CHUNK):
        sl = slice(start, start + EDGE_CHUNK)
        w = w_obs[sl]
        outer = w[:, :, None] * w[:, None, :] * outer_weight[sl, None, None]
        precision.index_add_(0, patient[sl], outer)
        rhs.index_add_(0, patient[sl], w * rhs_weight[sl, None])


def _posterior(precision: torch.Tensor, rhs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A^-1 rhs, A^-1)`` of symmetric positive definite ``A`` per patient."""
    chol = torch.linalg.cholesky(precision)
    return torch.cholesky_solve(rhs[..., None], chol)[..., 0], torch.cholesky_inverse(chol)


def gaussian_posterior_means(
    w_lab,
    signal: float,
    obs_patient,
    obs_lab,
    obs_values,
    num_patients: int,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-patient posterior ``(mean [P, k], covariance [P, k, k])`` of z
    given the observed values, float64 tensors on ``device``.  Patients
    with no observations keep the prior (mean 0, covariance I)."""
    device = resolve_device(device)
    w_lab = _f64(w_lab, device)
    k = w_lab.shape[1]
    s = float(signal)
    sigma2 = max(1.0 - s * s, 1e-12)
    obs_patient = _index(obs_patient, device)
    w_obs = w_lab[_index(obs_lab, device)]
    values = _f64(obs_values, device)
    precision = torch.eye(k, dtype=torch.float64, device=device).repeat(num_patients, 1, 1)
    rhs = torch.zeros(num_patients, k, dtype=torch.float64, device=device)
    _accumulate(
        precision, rhs, w_obs, obs_patient,
        torch.full_like(values, s * s / sigma2), (s / sigma2) * values,
    )
    return _posterior(precision, rhs)


def gaussian_conditional_ceiling(
    w_lab,
    signal: float,
    obs_patient,
    obs_lab,
    obs_values,
    query_patient,
    query_lab,
    query_values=None,
    num_patients: Optional[int] = None,
    device=None,
) -> Dict:
    """Bayes-optimal prediction of the query edges given the observed ones
    (the train split): ``expected`` (exact, over the noise) and, with
    ``query_values``, ``realized`` metrics, ``unconditional_r2`` (s^2),
    ``predictions`` and ``mean_posterior_var``."""
    device = resolve_device(device)
    if num_patients is None:
        num_patients = int(max(np.max(np.asarray(obs_patient)), np.max(np.asarray(query_patient)))) + 1
    s = float(signal)
    sigma2 = max(1.0 - s * s, 1e-12)
    mu, cov = gaussian_posterior_means(
        w_lab, s, obs_patient, obs_lab, obs_values, num_patients, device=device
    )
    qp = _index(query_patient, device)
    w_q = _f64(w_lab, device)[_index(query_lab, device)]
    predictions = s * (w_q * mu[qp]).sum(-1)
    # exact residual variance per query: s^2 w^T cov w + sigma^2
    resid_var = s * s * torch.einsum("qi,qij,qj->q", w_q, cov[qp], w_q) + sigma2
    out: Dict = {
        "expected": {
            "r2": float(1.0 - resid_var.mean()),  # Var(v) == 1 by construction
            # residuals are Gaussian: E|resid| = sqrt(2 / pi) std
            "mae": float(np.sqrt(2.0 / np.pi) * resid_var.sqrt().mean()),
            "rmse": float(resid_var.mean().sqrt()),
        },
        "unconditional_r2": s * s,
        "predictions": predictions.cpu().numpy(),
        "mean_posterior_var": float(
            torch.diagonal(cov.sum(0)).sum() / (num_patients * cov.shape[1])
        ),
    }
    if query_values is not None:
        out["realized"] = compute_regression_metrics(out["predictions"], np.asarray(query_values))
    return out


def crossfit_oracle_ceiling(
    w_lab,
    signal: float,
    z,
    features,
    query_patient,
    query_lab,
    query_values,
    regs: tuple = (1.0, 10.0, 30.0, 100.0, 300.0),
    folds: int = 5,
    seed: int = 7,
    device=None,
) -> Dict:
    """The empirical oracle ceiling of ``features`` (anything a model could
    condition on): ridge-fit ``z ~ [features, 1]`` cross-fitted over
    patients (a patient's own z never enters its fit), predict ``s <w_l,
    zhat_p>`` on the query edges, and keep the regularizer with the best
    query R^2 (optimism is fine in a ceiling).  Returns ``realized``,
    ``reg`` and ``folds``."""
    device = resolve_device(device)
    w_lab = _f64(w_lab, device)
    z = _f64(z, device)
    num_patients, k = z.shape
    s = float(signal)
    perm = np.random.default_rng(seed).permutation(num_patients)
    feats = torch.cat(
        [_f64(features, device), torch.ones(num_patients, 1, dtype=torch.float64, device=device)], 1
    )
    d = feats.shape[1]
    eye = torch.eye(d, dtype=torch.float64, device=device)
    qp, w_q = _index(query_patient, device), w_lab[_index(query_lab, device)]
    query_values = np.asarray(query_values)

    best: Dict = {}
    for reg in regs:
        zhat = torch.zeros(num_patients, k, dtype=torch.float64, device=device)
        for f in range(folds):
            hold = perm[f::folds]
            mask = np.ones(num_patients, bool)
            mask[hold] = False
            fit = torch.as_tensor(np.flatnonzero(mask), device=device)
            hold = torch.as_tensor(hold, device=device)
            f_fit = feats[fit]
            coef = torch.linalg.solve(f_fit.T @ f_fit + reg * eye, f_fit.T @ z[fit])
            zhat[hold] = feats[hold] @ coef
        pred = (s * (w_q * zhat[qp]).sum(-1)).cpu().numpy()
        m = compute_regression_metrics(pred, query_values)
        if not best or m["r2"] > best["realized"]["r2"]:
            best = {"realized": m, "reg": reg}
    best["folds"] = folds
    return best


def lmmse_conditional_ceiling(
    w_eff,
    noise_var,
    z_cov,
    obs_patient,
    obs_lab,
    obs_values,
    query_patient,
    query_lab,
    query_values,
    mean_shift=None,
    num_patients: Optional[int] = None,
    device=None,
) -> Dict:
    """The heteroscedastic LMMSE ceiling of the eicu generator's effective
    model ``value_norm ~= <w_eff[l], z> - mean_shift[l] + noise``,
    ``Var(noise | l) = noise_var[l]``: per patient the GLS posterior

        z_hat_p = (C^-1 + sum_l W_l W_l^T / s2_l)^-1 sum_l W_l y_l / s2_l

    with ``C = z_cov``.  The eicu latents are not jointly Gaussian, so this
    is the best *linear* predictor, a strong yardstick and no upper-bound
    certificate.  Returns ``realized`` metrics and ``predictions``."""
    device = resolve_device(device)
    w_eff = _f64(w_eff, device)
    noise_var = _f64(noise_var, device)
    shift = (
        torch.zeros(w_eff.shape[0], dtype=torch.float64, device=device)
        if mean_shift is None
        else _f64(mean_shift, device)
    )
    if num_patients is None:
        num_patients = int(max(np.max(np.asarray(obs_patient)), np.max(np.asarray(query_patient)))) + 1
    k = w_eff.shape[1]
    eye = torch.eye(k, dtype=torch.float64, device=device)
    obs_l = _index(obs_lab, device)
    w_obs = w_eff[obs_l]
    inv_s2 = 1.0 / noise_var[obs_l].clamp_min(1e-8)
    precision = torch.linalg.inv(_f64(z_cov, device) + 1e-9 * eye).repeat(num_patients, 1, 1)
    rhs = torch.zeros(num_patients, k, dtype=torch.float64, device=device)
    y = _f64(obs_values, device) + shift[obs_l]
    _accumulate(precision, rhs, w_obs, _index(obs_patient, device), inv_s2, y * inv_s2)
    z_hat, _ = _posterior(precision, rhs)
    ql = _index(query_lab, device)
    predictions = ((w_eff[ql] * z_hat[_index(query_patient, device)]).sum(-1) - shift[ql]).cpu().numpy()
    return {
        "realized": compute_regression_metrics(
            predictions, np.asarray(query_values, dtype=np.float64)
        ),
        "predictions": predictions,
    }
