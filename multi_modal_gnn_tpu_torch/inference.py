"""Per-patient inference reports (``multi_modal_gnn_tpu/inference.py``).

For each selected patient every lab is classified as measured (train or
val split), masked (test split: prediction against the actual value) or
truly missing (no edge), predictions are denormalized to original units
with conformal intervals, and ``inference_examples.json`` is written.  All
the report patients' (patient, lab) pairs go through one eval forward
(:meth:`Trainer.predict_pairs`).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.graph.build import GraphBundle, Table
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_DIAGNOSIS, PATIENT_MEDICATION
from multi_modal_gnn_tpu_torch.utils.io import save_json

logger = logging.getLogger(__name__)


class Denormalizer:
    """Maps graph lab indices to original-unit values.

    Prefers a fitted normalizer table (interim ``normalizer.npz``: columns
    ``lab_id``, ``center``, ``scale`` and optionally ``method``), whose
    inverse is ``value * scale + center``; else falls back to
    ``GraphMeta.lab_stats`` (raw-value mean / std), exact only for zscore.
    The synthetic route writes no normalizer table."""

    def __init__(self, meta, normalizer: Optional[Table] = None, method: str = "zscore"):
        self.meta = meta
        self._method = method
        self._affine: Dict[int, tuple] = {}
        if normalizer is not None and len(normalizer["lab_id"]):
            if "method" in normalizer:
                self._method = str(normalizer["method"][0])
            indexer = meta.indexers.get(LAB)
            rows = zip(normalizer["lab_id"].tolist(), normalizer["center"], normalizer["scale"])
            for lab_id, center, scale in rows:
                idx = indexer.get(lab_id) if indexer is not None else None
                if idx is not None:
                    affine = (float(center), float(scale))
                    self._affine[int(idx)] = (0.0, 1.0) if self._method == "none" else affine
        elif method != "zscore":
            logger.warning(
                "No fitted normalizer available; falling back to raw-value "
                "mean/std, which is only exact for zscore (configured: %s)",
                method,
            )

    def __call__(self, lab_idx: int, value: float) -> float:
        affine = self._affine.get(int(lab_idx))
        if affine is not None:
            center, scale = affine
            if scale == 0:
                # a degenerate scale shifts by center (zscore / robust) or
                # collapses to 0 (minmax)
                return float(center if self._method == "minmax" else value + center)
            return float(value * scale + center)
        stats = self.meta.lab_stats.get(int(lab_idx))
        if not stats:
            return float(value)
        return float(value * stats.get("std", 1.0) + stats.get("mean", 0.0))


def load_fitted_normalizer(interim_dir) -> Optional[Table]:
    """The preprocess stage's normalizer table, if it wrote one."""
    path = Path(interim_dir) / "normalizer.npz"
    if not path.exists():
        return None
    from multi_modal_gnn_tpu_torch.data.preprocess import load_table

    return load_table(path)


def load_patient_context(
    bundle: GraphBundle, patient_idx: int, cohort: Optional[Table] = None, max_items: int = 10
) -> Dict:
    """Diagnoses and medications of a patient (from the host edges and the
    indexers) and, given the cohort table, age and gender."""
    meta = bundle.meta
    context: Dict = {
        "patient_id": meta.indexers[PATIENT].id_of(patient_idx)
        if PATIENT in meta.indexers
        else patient_idx
    }
    for key, et in (("diagnoses", PATIENT_DIAGNOSIS), ("medications", PATIENT_MEDICATION)):
        items: List = []
        if bundle.host_edges and et in bundle.host_edges:
            src, dst, _ = bundle.host_edges[et]
            indexer = meta.indexers.get(et[2])
            items = [
                indexer.id_of(int(i)) if indexer else int(i)
                for i in dst[src == patient_idx][:max_items]
            ]
        context[key] = items
    if cohort is not None and "SUBJECT_ID" in cohort:
        rows = np.flatnonzero(np.asarray(cohort["SUBJECT_ID"]) == context["patient_id"])
        if len(rows):
            row = rows[0]
            context["age"] = float(cohort["AGE"][row]) if "AGE" in cohort else float("nan")
            context["gender"] = str(cohort["GENDER"][row]) if "GENDER" in cohort else "N/A"
    return context


def classify_patient_labs(masker, patient_idx: int) -> Dict[str, Dict[int, float]]:
    """``{"measured": {lab_idx: value}, "masked": {lab_idx: value}}`` of a
    patient's edges, "masked" being those in the test split."""
    positions = np.flatnonzero(masker._p == patient_idx)
    in_test = np.isin(positions, masker.split_indices("test"))
    measured, masked = {}, {}
    for pos, test in zip(positions, in_test):
        (masked if test else measured)[int(masker._l[pos])] = float(masker._v[pos])
    return {"measured": measured, "masked": masked}


def select_example_patients(
    masker, num_patients: int, num_examples: int, rng: np.random.Generator
) -> List[int]:
    """The lowest, median and highest lab-count patients, then a random
    fill (JAX ``select_example_patients``, the same draws)."""
    degree = np.bincount(masker._p, minlength=num_patients)
    observed = np.where(degree > 0)[0]
    if len(observed) == 0:
        return []
    order = observed[np.argsort(degree[observed])]
    picks: List[int] = []
    for idx in (0, len(order) // 2, len(order) - 1):
        pid = int(order[idx])
        if pid not in picks:
            picks.append(pid)
    remaining = [int(x) for x in observed if x not in picks]
    rng.shuffle(remaining)
    picks.extend(remaining[: max(num_examples - len(picks), 0)])
    return picks[:num_examples]


def predict_for_patients(
    trainer, bundle: GraphBundle, patient_indices: List[int], denorm=None, conformal=None,
) -> Dict[int, Dict]:
    """Every lab of each patient predicted in one forward of the live
    model, then grouped into measured / masked / truly missing; with a
    ``conformal`` calibrator each prediction carries its ``interval``
    (original units) and ``normalized_interval``."""
    meta = bundle.meta
    denorm = denorm if denorm is not None else Denormalizer(meta)
    num_labs = bundle.graph.num_nodes(LAB)
    pairs_p = np.repeat(np.asarray(patient_indices, dtype=np.int32), num_labs)
    pairs_l = np.tile(np.arange(num_labs, dtype=np.int32), len(patient_indices))
    preds = trainer.predict_pairs(pairs_p, pairs_l)
    radius = conformal.radius(np.arange(num_labs)) if conformal is not None else None

    def _interval(lab_idx: int, pred_n: float) -> Dict:
        if radius is None:
            return {}
        lo_n, hi_n = pred_n - radius[lab_idx], pred_n + radius[lab_idx]
        lo, hi = sorted((denorm(lab_idx, lo_n), denorm(lab_idx, hi_n)))
        return {"interval": [lo, hi], "normalized_interval": [float(lo_n), float(hi_n)]}

    out: Dict[int, Dict] = {}
    for i, pid in enumerate(patient_indices):
        patient_preds = preds[i * num_labs : (i + 1) * num_labs]
        groups = classify_patient_labs(trainer.masker, pid)
        measured, masked, missing = {}, {}, {}
        for lab_idx in range(num_labs):
            name = meta.lab_names.get(lab_idx, f"Lab_{lab_idx}")
            pred_n = float(patient_preds[lab_idx])
            if lab_idx in groups["masked"]:
                actual_n = groups["masked"][lab_idx]
                masked[name] = {
                    "predicted": denorm(lab_idx, pred_n),
                    "actual": denorm(lab_idx, actual_n),
                    "error": abs(denorm(lab_idx, pred_n) - denorm(lab_idx, actual_n)),
                    "normalized_predicted": pred_n,
                    "normalized_actual": actual_n,
                    **_interval(lab_idx, pred_n),
                }
            elif lab_idx in groups["measured"]:
                actual_n = groups["measured"][lab_idx]
                measured[name] = {"value": denorm(lab_idx, actual_n), "normalized": actual_n}
            else:
                missing[name] = {
                    "predicted": denorm(lab_idx, pred_n),
                    "normalized_predicted": pred_n,
                    "note": "Lab was never measured for this patient",
                    **_interval(lab_idx, pred_n),
                }
        out[pid] = {
            "patient_id": meta.indexers[PATIENT].id_of(pid) if PATIENT in meta.indexers else pid,
            "num_measured": len(measured),
            "measured_labs": measured,
            "masked_labs": masked,
            "truly_missing_labs": missing,
        }
    return out


def print_patient_report(report: Dict, detailed: bool = False) -> str:
    """A human-readable per-patient report, printed and returned."""
    lines = [
        "=" * 66,
        f"Patient {report['patient_id']} — {report['num_measured']} labs measured",
        "=" * 66,
    ]
    ctx = report.get("context") or {}
    demo_bits = [
        f"age {ctx['age']:.0f}" if "age" in ctx else None,
        f"gender {ctx['gender']}" if "gender" in ctx else None,
    ]
    if any(demo_bits):
        lines.append("  " + ", ".join(b for b in demo_bits if b))
    if ctx.get("diagnoses"):
        lines.append(f"  diagnoses: {', '.join(str(d) for d in ctx['diagnoses'])}")
    if ctx.get("medications"):
        lines.append(f"  medications: {', '.join(str(m) for m in ctx['medications'])}")
    if report["masked_labs"]:
        lines.append("\nHeld-out (test) labs — prediction vs actual:")
        for name, info in sorted(report["masked_labs"].items()):
            iv = info.get("interval")
            iv_s = f"  [{iv[0]:.2f}, {iv[1]:.2f}]" if iv else ""
            lines.append(
                f"  {name:<30} pred {info['predicted']:>10.2f}  "
                f"actual {info['actual']:>10.2f}  err {info['error']:.2f}{iv_s}"
            )
    if detailed and report["measured_labs"]:
        lines.append("\nMeasured labs:")
        for name, info in sorted(report["measured_labs"].items()):
            lines.append(f"  {name:<30} {info['value']:>10.2f}")
    if report["truly_missing_labs"]:
        lines.append(f"\nImputed (never measured): {len(report['truly_missing_labs'])} labs")
        if detailed:
            for name, info in sorted(report["truly_missing_labs"].items()):
                lines.append(f"  {name:<30} pred {info['predicted']:>10.2f}")
    text = "\n".join(lines)
    print(text)
    return text


def run_inference(
    config: Config,
    bundle: GraphBundle,
    trainer,
    output_dir,
    patient_id=None,
    num_examples: int = 5,
    detailed: bool = False,
    cohort: Optional[Table] = None,
) -> Dict:
    """Reports for ``patient_id`` (an entity ID) or ``num_examples``
    sampled patients, with conformal intervals at
    ``evaluation.conformal_alpha``, and their error summary, written to
    ``inference_examples.json``."""
    from multi_modal_gnn_tpu_torch.evaluation.conformal import calibrate_from_trainer

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    meta = bundle.meta
    rng = np.random.default_rng(config.train.seed)
    if patient_id is not None:
        idx = meta.indexers[PATIENT].get(patient_id) if PATIENT in meta.indexers else None
        if idx is None:
            raise ValueError(f"Unknown patient id: {patient_id}")
        patient_indices = [idx]
    else:
        patient_indices = select_example_patients(
            trainer.masker, bundle.graph.num_nodes(PATIENT), num_examples, rng
        )

    denorm = Denormalizer(
        meta, load_fitted_normalizer(config.data.interim_dir),
        method=config.feature_space.labs.normalize,
    )
    conformal = None
    alpha = config.evaluation.extras.get("conformal_alpha", 0.1)
    if alpha:
        try:
            # the reports predict with the live model: calibrate it
            conformal = calibrate_from_trainer(
                trainer, alpha=float(alpha), state=trainer.model.state_dict()
            )
        except ValueError as e:  # the split is too small for this level
            logger.warning("Conformal intervals skipped: %s", e)
    reports = predict_for_patients(trainer, bundle, patient_indices, denorm=denorm, conformal=conformal)
    for idx, report in reports.items():
        report["context"] = load_patient_context(bundle, idx, cohort=cohort)
        print_patient_report(report, detailed=detailed)

    masked = [info for r in reports.values() for info in r["masked_labs"].values()]
    errors = [info["error"] for info in masked]
    norm_errors = [abs(info["normalized_predicted"] - info["normalized_actual"]) for info in masked]
    summary = {
        "num_patients": len(reports),
        "num_masked_predictions": len(errors),
        "mean_abs_error_original_units": float(np.mean(errors)) if errors else None,
        "mean_abs_error_normalized": float(np.mean(norm_errors)) if norm_errors else None,
    }
    if conformal is not None:
        in_interval = [
            info["normalized_interval"][0] <= info["normalized_actual"] <= info["normalized_interval"][1]
            for info in masked
            if "normalized_interval" in info
        ]
        summary["interval_alpha"] = conformal.alpha
        summary["interval_coverage_on_masked"] = float(np.mean(in_interval)) if in_interval else None
    result = {"examples": list(reports.values()), "summary": summary}
    save_json(result, output_dir / "inference_examples.json")
    logger.info("Inference summary: %s", summary)
    return result
