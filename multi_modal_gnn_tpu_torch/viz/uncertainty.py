"""Uncertainty visualizations for the conformal intervals
(``multi_modal_gnn_tpu/viz/uncertainty.py``), under
``<output>/uncertainty_visualizations/``:

* interval_width_per_lab — calibrated per-lab interval widths, sorted,
  with the global radius line;
* coverage_per_lab — empirical test coverage per lab against the target
  level, with a binomial band for each lab's sample size;
* coverage_calibration — observed against nominal coverage over a grid of
  levels, for the conformal interval and the Gaussian ``pred +/- z sigma``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

from multi_modal_gnn_tpu_torch.evaluation.conformal import ConformalCalibrator, calibrate_from_trainer
from multi_modal_gnn_tpu_torch.viz import Figures, TrainerOutputs

logger = logging.getLogger(__name__)

_NORMAL_Q = {  # z_{1-alpha/2} for the Gaussian comparison curve
    0.05: 1.9600, 0.10: 1.6449, 0.15: 1.4395, 0.20: 1.2816,
    0.30: 1.0364, 0.40: 0.8416, 0.50: 0.6745,
}


def plot_interval_width_per_lab(
    calibrator: ConformalCalibrator, lab_names: dict, out: Path, figures: Figures, top_n: int = 40
) -> None:
    widths = 2.0 * calibrator.q_lab
    order = np.argsort(widths)
    if len(order) > top_n:  # the narrowest and the widest halves
        order = np.concatenate([order[: top_n // 2], order[-top_n // 2:]])
    names = [lab_names.get(int(i), f"Lab_{int(i)}") for i in order]

    def plot(plt):
        fig, ax = plt.subplots(figsize=(8, max(3.0, 0.22 * len(order))))
        ax.barh(np.arange(len(order)), widths[order], color="#4878a8")
        ax.axvline(2.0 * calibrator.q_global, color="#b04030", ls="--",
                   label=f"global width {2 * calibrator.q_global:.2f}")
        ax.set_yticks(np.arange(len(order)))
        ax.set_yticklabels(names, fontsize=7)
        ax.set_xlabel(f"{100 * (1 - calibrator.alpha):.0f}% interval width (normalized units)")
        ax.set_title("Calibrated per-lab interval width")
        ax.legend(fontsize=8)
        return fig

    figures.draw(out / "interval_width_per_lab.png", plot)


def plot_coverage_per_lab(
    calibrator: ConformalCalibrator,
    preds: np.ndarray,
    targets: np.ndarray,
    lab_idx: np.ndarray,
    lab_names: dict,
    out: Path,
    figures: Figures,
    min_samples: int = 20,
) -> None:
    covered = np.abs(preds - targets) <= calibrator.radius(lab_idx)
    num_labs = len(calibrator.q_lab)
    hit = np.bincount(lab_idx, weights=covered, minlength=num_labs)
    tot = np.bincount(lab_idx, minlength=num_labs)
    keep = np.flatnonzero(tot >= min_samples)
    if not len(keep):
        logger.warning("No lab reaches %d test samples; skipping coverage plot", min_samples)
        return
    cov = hit[keep] / tot[keep]
    order = keep[np.argsort(cov)]
    target = 1.0 - calibrator.alpha

    def plot(plt):
        fig, ax = plt.subplots(figsize=(max(6.0, 0.18 * len(order)), 4))
        x = np.arange(len(order))
        ax.bar(x, (hit[order] / tot[order]), color="#4878a8")
        ax.axhline(target, color="#b04030", ls="--", label=f"target {target:.0%}")
        # +-2 binomial standard errors at each lab's own n
        se = 2.0 * np.sqrt(target * (1 - target) / tot[order])
        ax.fill_between(x, target - se, np.minimum(target + se, 1.0),
                        color="#b04030", alpha=0.15, label="±2 binomial SE")
        ax.set_xticks(x)
        ax.set_xticklabels(
            [lab_names.get(int(i), f"Lab_{int(i)}") for i in order],
            rotation=90, fontsize=6,
        )
        ax.set_ylim(0, 1.02)
        ax.set_ylabel("empirical test coverage")
        ax.set_title("Per-lab interval coverage")
        ax.legend(fontsize=8)
        return fig

    figures.draw(out / "coverage_per_lab.png", plot)


def coverage_curves(
    val_pred: np.ndarray,
    val_targets: np.ndarray,
    val_lab_idx: np.ndarray,
    te_pred: np.ndarray,
    te_targets: np.ndarray,
    te_lab_idx: np.ndarray,
    num_labs: int,
):
    """``(nominal, conformal observed, Gaussian observed)`` test coverage
    over :data:`_NORMAL_Q`'s levels (a level the calibration split cannot
    certify is skipped)."""
    nominal, conf_obs, gauss_obs = [], [], []
    err = np.abs(te_pred - te_targets)
    sigma = float(np.std(val_pred - val_targets))
    for a in sorted(_NORMAL_Q):
        try:
            cal = ConformalCalibrator.fit(val_pred, val_targets, val_lab_idx, num_labs, alpha=a)
        except ValueError:
            continue
        nominal.append(1.0 - a)
        conf_obs.append(float(np.mean(err <= cal.radius(te_lab_idx))))
        gauss_obs.append(float(np.mean(err <= _NORMAL_Q[a] * sigma)))
    return nominal, conf_obs, gauss_obs


def plot_coverage_calibration(nominal, conf_obs, gauss_obs, out: Path, figures: Figures) -> None:
    def plot(plt):
        fig, ax = plt.subplots(figsize=(5.5, 5))
        ax.plot([0.4, 1.0], [0.4, 1.0], color="gray", lw=1, label="ideal")
        ax.plot(nominal, conf_obs, "o-", color="#4878a8", label="conformal")
        ax.plot(nominal, gauss_obs, "s--", color="#b04030", label="Gaussian z·σ")
        ax.set_xlabel("nominal coverage")
        ax.set_ylabel("observed test coverage")
        ax.set_title("Coverage calibration")
        ax.legend(fontsize=9)
        return fig

    figures.draw(out / "coverage_calibration.png", plot)


def run_uncertainty_visualizations(
    config, bundle, trainer, output_dir="outputs", figures: Optional[Figures] = None,
    outputs: Optional[TrainerOutputs] = None,
) -> Optional[Path]:
    """Calibrate on the calibration split (``calibrate_from_trainer``), plot
    widths, coverage and calibration on test.  Returns the directory, or
    None when the calibration split cannot certify the configured level."""
    alpha = config.evaluation.extras.get("conformal_alpha", 0.1) or 0.1
    try:
        calibrator = calibrate_from_trainer(trainer, alpha=float(alpha))
    except ValueError as e:
        logger.warning("Uncertainty visualizations skipped: %s", e)
        return None
    out = Path(output_dir) / "uncertainty_visualizations"
    figures = figures if figures is not None else Figures()
    outputs = outputs if outputs is not None else TrainerOutputs(trainer)
    _, te_l, te_v = trainer.masker.split_arrays("test")
    te_pred = outputs("test").astype(np.float64)
    _, va_l, va_v = trainer.masker.split_arrays("val")
    va_pred = outputs("val").astype(np.float64)
    lab_names = bundle.meta.lab_names

    plot_interval_width_per_lab(calibrator, lab_names, out, figures)
    # tiny cohorts: relax the per-lab sample floor instead of going blank
    counts = np.bincount(te_l, minlength=len(calibrator.q_lab))
    min_samples = 20 if int(counts.max(initial=0)) >= 20 else 5
    plot_coverage_per_lab(calibrator, te_pred, te_v, te_l, lab_names, out, figures, min_samples=min_samples)
    plot_coverage_calibration(
        *coverage_curves(va_pred, va_v, va_l, te_pred, te_v, te_l, len(calibrator.q_lab)), out, figures
    )
    return out
