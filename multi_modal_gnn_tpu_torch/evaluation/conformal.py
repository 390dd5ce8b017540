"""Split-conformal prediction intervals for imputed lab values
(``multi_modal_gnn_tpu/evaluation/conformal.py``), in numpy and scipy.

Split conformal regression on absolute residuals: calibrated on a held-out
split of n exchangeable residuals, the interval ``pred +/- q`` with
``q = s_(ceil((n+1)(1-alpha)))`` covers a fresh target with probability at
least ``1 - alpha``, for any predictor.  Per-lab (Mondrian) radii adapt to
each lab's residual scale, with the global radius for labs whose
calibration count cannot support the corrected quantile.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from multi_modal_gnn_tpu_torch.graph.schema import LAB

logger = logging.getLogger(__name__)


def beta_coverage_quantile(n: int, alpha: float, q: float = 0.05) -> float:
    """q-quantile of the CONDITIONAL coverage of a split-conformal interval
    calibrated on ``n`` samples at level ``alpha``.

    For continuous scores, coverage conditional on the calibration draw is
    distributed ``Beta(k, n + 1 - k)`` with ``k = ceil((n+1)(1-alpha))``
    (Vovk 2012, "Conditional validity of inductive conformal predictors") —
    the marginal guarantee ``E[coverage] = k/(n+1) >= 1-alpha`` hides this
    calibration-draw variance, which is exactly what makes small-n per-lab
    (Mondrian) coverage wobble.  The returned value is a probabilistic
    lower bound: with probability ``1 - q`` over calibration draws, the
    realized conditional coverage is at least it.  Returns 0.0 when n
    cannot certify alpha (radius would be inf -> coverage 1.0 trivially,
    but that lab falls back to the global radius anyway).
    """
    k = math.ceil((n + 1) * (1.0 - alpha))
    if n <= 0 or k > n:
        return 0.0
    from scipy.stats import beta as _beta

    return float(_beta.ppf(q, k, n + 1 - k))


def min_per_lab_for_bound(
    alpha: float, target: float, q: float = 0.05, n_max: int = 10_000
) -> int:
    """Smallest per-lab calibration count from which the Beta
    conditional-coverage q-quantile stays at or above ``target`` for ALL
    larger counts — the principled way to choose ``min_per_lab``: below
    this, a lab's own radius cannot promise ``target`` coverage with
    ``1-q`` confidence and the global fallback is the better bet.  E.g.
    alpha=0.1, target=0.8, q=0.05 -> 30 (the class default).

    "For all larger counts" matters: the quantile rises toward ``1-alpha``
    with n but sawtooths at each jump of the order-statistic index k (at
    tiny n, k=n makes the radius the max score, which over-covers), so
    "first n that clears the target" would admit counts whose successors
    fall back below it."""
    if not target < 1.0 - alpha:
        raise ValueError(
            f"target {target} must be < 1-alpha = {1.0 - alpha} "
            "(the quantile's asymptote)"
        )
    qs = np.array([beta_coverage_quantile(n, alpha, q) for n in range(1, n_max + 1)])
    failing = np.nonzero(qs < target)[0]
    if failing.size == 0:
        return 1
    n = int(failing[-1]) + 2  # index->n is +1, first PASSING n is +1 more
    if n > n_max:
        raise ValueError(
            f"target {target} unreachable at alpha={alpha} within n<={n_max}"
        )
    return n


def conformal_quantile(scores: np.ndarray, alpha: float) -> float:
    """Finite-sample-corrected (1-alpha) quantile of conformity scores.

    Returns ``s_(k)`` with ``k = ceil((n+1)(1-alpha))`` (1-indexed order
    statistic), the smallest radius with the split-conformal coverage
    guarantee.  Returns ``inf`` when ``k > n`` — i.e. n is too small to
    certify level alpha (n must be at least ``(1-alpha)/alpha``).
    """
    scores = np.asarray(scores, dtype=np.float64)
    n = scores.size
    if n == 0:
        return float("inf")
    k = math.ceil((n + 1) * (1.0 - alpha))
    if k > n:
        return float("inf")
    return float(np.sort(scores)[k - 1])


@dataclasses.dataclass
class ConformalCalibrator:
    """Per-lab symmetric prediction-interval radii with a global fallback.

    ``q_lab[l]`` is the certified radius for lab ``l`` (already filled with
    the global radius where the lab's calibration count is below
    ``min_per_lab`` or cannot support the corrected quantile), so interval
    construction is a single gather: ``pred +/- q_lab[lab_idx]``.
    """

    alpha: float
    q_global: float
    q_lab: np.ndarray  # [num_labs] float64, fallback-filled
    cal_counts: np.ndarray  # [num_labs] int64 calibration samples per lab
    min_per_lab: int = 30

    @classmethod
    def fit(
        cls,
        predictions: np.ndarray,
        targets: np.ndarray,
        lab_indices: np.ndarray,
        num_labs: int,
        alpha: float = 0.1,
        min_per_lab: int | str = 30,
    ) -> "ConformalCalibrator":
        """Calibrate on a held-out split (predictions vs targets).

        The calibration split must be disjoint from both the training data
        (residuals there are optimistically biased) and the split whose
        coverage will be reported (coverage there would be in-sample).  The
        evaluation pipeline uses the dedicated calibration split when the
        masker carved one (``evaluation.conformal_split_fraction``), else
        the validation split.

        ``min_per_lab="auto"`` chooses the count from the finite-sample
        Beta bound (:func:`min_per_lab_for_bound`): the smallest n whose
        conditional coverage is at least ``1 - 2*alpha`` with 95%
        confidence — labs below it can't responsibly carry their own
        radius and fall back to the global one.
        """
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if min_per_lab == "auto":
            min_per_lab = min_per_lab_for_bound(
                alpha, target=max(1.0 - 2.0 * alpha, 0.5), q=0.05
            )
        predictions = np.asarray(predictions, dtype=np.float64)
        targets = np.asarray(targets, dtype=np.float64)
        lab_indices = np.asarray(lab_indices, dtype=np.int64)
        scores = np.abs(predictions - targets)

        q_global = conformal_quantile(scores, alpha)
        if not np.isfinite(q_global):
            raise ValueError(
                f"calibration set of {scores.size} samples cannot certify "
                f"alpha={alpha} (needs at least {math.ceil(1 / alpha)})"
            )
        counts = np.bincount(lab_indices, minlength=num_labs).astype(np.int64)
        q_lab = np.full(num_labs, q_global, dtype=np.float64)
        for lab in np.flatnonzero(counts >= max(min_per_lab, 1)):
            q = conformal_quantile(scores[lab_indices == lab], alpha)
            if np.isfinite(q):
                q_lab[lab] = q
        return cls(
            alpha=float(alpha),
            q_global=float(q_global),
            q_lab=q_lab,
            cal_counts=counts,
            min_per_lab=int(min_per_lab),
        )

    # -- interval construction ------------------------------------------

    def radius(self, lab_indices: np.ndarray) -> np.ndarray:
        return self.q_lab[np.asarray(lab_indices, dtype=np.int64)]

    def intervals(
        self, predictions: np.ndarray, lab_indices: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``(lower, upper)`` bounds, each shaped like ``predictions``."""
        predictions = np.asarray(predictions, dtype=np.float64)
        r = self.radius(lab_indices)
        return predictions - r, predictions + r

    def coverage_bounds(self, q: float = 0.05) -> Dict:
        """Finite-sample conditional-coverage lower bounds per lab.

        For each lab serving its OWN radius (``cal_counts >= min_per_lab``),
        the Beta(k, n+1-k) q-quantile of its conditional coverage
        (:func:`beta_coverage_quantile`); labs on the global fallback carry
        the global bound (their radius IS the global quantile, calibrated
        on the full set — the per-lab conditional coverage of the fallback
        is not exchangeability-guaranteed, so the global bound is the
        honest number for them).  ``worst_lab_bound`` is the min over
        own-radius labs — the pinnable promise "every per-lab radius
        covers at least this, with 1-q confidence over calibration draws".
        """
        own = self.cal_counts >= self.min_per_lab
        per_lab = np.array(
            [
                beta_coverage_quantile(int(n), self.alpha, q) if is_own else float("nan")
                for n, is_own in zip(self.cal_counts, own)
            ]
        )
        n_global = int(self.cal_counts.sum())
        own_vals = per_lab[own]
        return {
            "q": float(q),
            "global_bound": beta_coverage_quantile(n_global, self.alpha, q),
            "per_lab_bound": [None if np.isnan(b) else float(b) for b in per_lab],
            # None (not NaN) when no lab carries its own radius: these dicts
            # are json.dumps'd into serving sidecars, and a bare NaN token is
            # rejected by strict JSON parsers (mirrors per_lab_bound)
            "worst_lab_bound": float(own_vals.min()) if own_vals.size else None,
            "num_own_radius_labs": int(own.sum()),
        }

    # -- evaluation ------------------------------------------------------

    def evaluate(
        self,
        predictions: np.ndarray,
        targets: np.ndarray,
        lab_indices: np.ndarray,
        min_lab_samples: int = 20,
    ) -> Dict:
        """Empirical coverage + width statistics on a disjoint split.

        ``per_lab_min_coverage`` is taken over labs with at least
        ``min_lab_samples`` test points (below that the empirical rate is
        too noisy to name a worst lab).
        """
        predictions = np.asarray(predictions, dtype=np.float64)
        targets = np.asarray(targets, dtype=np.float64)
        lab_indices = np.asarray(lab_indices, dtype=np.int64)
        r = self.radius(lab_indices)
        covered = np.abs(predictions - targets) <= r
        num_labs = len(self.q_lab)
        hit = np.bincount(lab_indices, weights=covered, minlength=num_labs)
        tot = np.bincount(lab_indices, minlength=num_labs)
        eligible = tot >= min_lab_samples
        per_lab_cov = hit[eligible] / tot[eligible] if eligible.any() else np.array([])
        bounds = self.coverage_bounds()
        return {
            "alpha": self.alpha,
            "target_coverage": 1.0 - self.alpha,
            "coverage": float(covered.mean()) if covered.size else float("nan"),
            "mean_width": float(2.0 * r.mean()) if r.size else float("nan"),
            "median_width": float(2.0 * np.median(r)) if r.size else float("nan"),
            "q_global": self.q_global,
            "num_samples": int(covered.size),
            "num_labs_calibrated": int(np.sum(self.cal_counts >= self.min_per_lab)),
            "per_lab_min_coverage": float(per_lab_cov.min()) if per_lab_cov.size else float("nan"),
            "per_lab_mean_coverage": float(per_lab_cov.mean()) if per_lab_cov.size else float("nan"),
            # finite-sample promises (what the radii CAN guarantee, as
            # opposed to the empirical rates above): see coverage_bounds
            "global_coverage_bound": bounds["global_bound"],
            "worst_lab_coverage_bound": bounds["worst_lab_bound"],
        }

    # -- serialization (serving manifest sidecar) ------------------------

    def to_dict(self) -> Dict:
        return {
            "alpha": self.alpha,
            "q_global": self.q_global,
            "q_lab": [float(q) for q in self.q_lab],
            "cal_counts": [int(c) for c in self.cal_counts],
            "min_per_lab": self.min_per_lab,
            # informational (ignored by from_dict): finite-sample promises
            "coverage_bounds": self.coverage_bounds(),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ConformalCalibrator":
        return cls(
            alpha=float(d["alpha"]),
            q_global=float(d["q_global"]),
            q_lab=np.asarray(d["q_lab"], dtype=np.float64),
            cal_counts=np.asarray(d["cal_counts"], dtype=np.int64),
            min_per_lab=int(d.get("min_per_lab", 30)),
        )

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict()))

    @classmethod
    def load(cls, path: str | Path) -> "ConformalCalibrator":
        return cls.from_dict(json.loads(Path(path).read_text()))


def calibrate_cold_start(
    als,
    masker,
    num_labs: int,
    alpha: float = 0.1,
    min_per_lab: int = 30,
    memberships: Optional[np.ndarray] = None,
) -> ConformalCalibrator:
    """Calibrator for the ALS fold-in (cold-start) serving channel, whose
    residuals differ from the graph model's.  Each patient of the "cal"
    split (when the masker carved one, else "val") is folded in from only
    their train-split labs, as ``ServingModel.predict_cold_start`` folds in
    an unseen patient, and their held-out labs are the queries.
    ``memberships`` (the full ``[num_patients, F]`` matrix) routes through
    the side-information fold-in of a :class:`SideInfoALSBaseline`.

    Those patients' train labs also fitted the lab factors, so the radii are
    mildly optimistic for a truly unseen patient: the coverage holds under
    an exchangeability approximation (JAX ``calibrate_cold_start``)."""
    cal_split = "cal" if getattr(masker, "has_calibration_split", False) else "val"
    tr_p, tr_l, tr_v = masker.split_arrays("train")
    va_p, va_l, va_v = masker.split_arrays(cal_split)
    order = np.argsort(tr_p, kind="stable")
    tr_p_s, tr_l_s, tr_v_s = tr_p[order], tr_l[order], tr_v[order]

    preds = np.empty(len(va_v), dtype=np.float64)
    for pid in np.unique(va_p):
        q = va_p == pid
        lo = np.searchsorted(tr_p_s, pid, side="left")
        hi = np.searchsorted(tr_p_s, pid, side="right")
        obs_l, obs_v = tr_l_s[lo:hi], tr_v_s[lo:hi]
        if memberships is not None:
            preds[q] = als.predict_cold_start(obs_l, obs_v, va_l[q], memberships[pid])
        else:
            preds[q] = als.predict_cold_start(obs_l, obs_v, va_l[q])
    return ConformalCalibrator.fit(
        preds, va_v, va_l, num_labs, alpha=alpha, min_per_lab=min_per_lab
    )


def calibrate_from_trainer(
    trainer, alpha: float = 0.1, min_per_lab: int | str = 30, state=None
) -> ConformalCalibrator:
    """Fit a calibrator on the trainer's calibration split.

    ``state`` selects the parameters to calibrate (default: the best-
    validation state when one was recorded — the state served and
    evaluated); pass the state being deployed if it differs.

    When the masker carved a dedicated "cal" split
    (``evaluation.conformal_split_fraction`` > 0), that split is used —
    the STRICT guarantee: those residuals never steered early stopping or
    LR plateaus.  Otherwise the validation split is used; its residual
    SCALE is then mildly optimistic relative to a never-touched split.
    """
    split = "cal" if getattr(trainer.masker, "has_calibration_split", False) else "val"
    _, val_l, val_t = trainer.masker.split_arrays(split)
    if state is None:
        state = trainer.best_state
    val_pred = np.asarray(trainer.predict(split, state=state), dtype=np.float64)
    return ConformalCalibrator.fit(
        val_pred, val_t, val_l, trainer.graph.num_nodes(LAB),
        alpha=alpha, min_per_lab=min_per_lab,
    )
