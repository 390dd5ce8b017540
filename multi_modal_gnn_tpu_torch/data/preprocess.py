"""The preprocess stage (``multi_modal_gnn_tpu/data/preprocess.py``): raw
eICU or MIMIC-III tables, or the ``data.synthetic`` cohort, to the interim
tables, one ``<name>.npz`` a table (its columns as arrays) in place of the
JAX package's parquet files.

The raw route: cohort selection, the top-K numeric labs of the cohort,
per-lab outlier removal and aggregation to one value per (patient, lab),
per-lab normalization (the fitted :class:`LabNormalizer`'s table is
``normalizer.npz``), ICD-9 codes collapsed to 3 digits, drug names
normalized, demographic features.  Every step keeps the row order and
the value semantics of the JAX package's pandas code (:mod:`utils.frame`).
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data.synthetic import generate_synthetic_tables, spec_from_config
from multi_modal_gnn_tpu_torch.utils import frame
from multi_modal_gnn_tpu_torch.utils.csv_table import to_numeric
from multi_modal_gnn_tpu_torch.utils.frame import Table
from multi_modal_gnn_tpu_torch.utils.normalizer import LabNormalizer, remove_outliers_grouped

logger = logging.getLogger(__name__)


def save_table(table: Table, path) -> Path:
    """A table's columns as one ``.npz``: strings as fixed-width unicode
    (missing strings empty), so no pickling is needed to read them back."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    columns = {}
    for name, col in table.items():
        col = np.asarray(col)
        if col.dtype == object:
            col = np.asarray(["" if m else str(v) for v, m in zip(col.tolist(), frame.isna(col))], dtype=str)
        columns[name] = col
    np.savez(path, **columns)
    return path


def load_table(path) -> Table:
    """A table written by :func:`save_table`, columns in their order."""
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


# -- labs ---------------------------------------------------------------------------


def aggregate_lab_values(
    labs: Table,
    cohort: Table,
    method: str = "last",
    remove_outliers_flag: bool = True,
    outlier_threshold: float = 5.0,
) -> Table:
    """One value per (patient, lab): outlier-clean, then aggregate.

    ``last`` keeps the value of the latest CHARTTIME after a stable sort by
    (SUBJECT_ID, ITEMID, CHARTTIME): a missing CHARTTIME sorts last and so
    wins, ties keep the file's order.  ``mean`` / ``median`` / ``min`` /
    ``max`` are grouped statistics, groups in key order.  Values beyond
    ``outlier_threshold`` per-lab standard deviations are dropped first."""
    labs = frame.take(labs, frame.isin(labs["SUBJECT_ID"], cohort["SUBJECT_ID"]))

    if remove_outliers_flag and frame.nrows(labs):
        labs = dict(labs)
        labs["VALUENUM"] = remove_outliers_grouped(labs, "VALUENUM", "ITEMID", outlier_threshold)
        labs = frame.take(labs, ~np.isnan(labs["VALUENUM"]))

    keys = ["SUBJECT_ID", "ITEMID"]
    if method == "last":
        labs = frame.take(labs, frame.sort_order(labs, [*keys, "CHARTTIME"]))
        g = frame.GroupBy(labs, keys)
        rows = np.nonzero(g.valid)[0]
        codes = g.codes[rows]
        last = rows[np.r_[codes[1:] != codes[:-1], True]] if len(rows) else rows
        agg = {"SUBJECT_ID": labs["SUBJECT_ID"][last], "ITEMID": labs["ITEMID"][last],
               "VALUE": labs["VALUENUM"][last]}
    elif method in ("mean", "median", "min", "max"):
        g = frame.GroupBy(labs, keys)
        agg = {**g.key_values, "VALUE": g.reduce(labs["VALUENUM"], method)}
    else:
        raise ValueError(f"Unknown aggregation method: {method}")
    logger.info("Aggregated to %d patient-lab pairs", frame.nrows(agg))
    return agg


def normalize_lab_values(labs_agg: Table, method: str = "zscore") -> Tuple[Table, LabNormalizer]:
    """Per-lab normalization (``VALUE_NORMALIZED``); returns the fitted
    normalizer for inverse transforms at inference time."""
    normalizer = LabNormalizer(method=method)
    out = dict(labs_agg)
    out["VALUE_NORMALIZED"] = normalizer.fit_transform_frame(out, "VALUE", "ITEMID")
    out = frame.take(out, ~np.isnan(out["VALUE_NORMALIZED"]))
    out["SUBJECT_ID"] = np.asarray(out["SUBJECT_ID"]).astype(np.int64)
    out["ITEMID"] = _try_int64(out["ITEMID"])  # string lab names (eICU) stay strings
    logger.info("Normalized %d lab values", frame.nrows(out))
    return out, normalizer


def _try_int64(col: np.ndarray) -> np.ndarray:
    """``astype("int64")`` where it succeeds, else the column unchanged."""
    col = np.asarray(col)
    if col.dtype.kind == "f" and not np.isfinite(col).all():
        return col
    try:
        return (np.asarray(col.tolist()) if col.dtype == object else col).astype(np.int64)
    except (ValueError, TypeError, OverflowError):
        return col


# -- diagnoses ----------------------------------------------------------------------


def _frequent(pairs: Table, code_col: str, min_patient_count: int, top_k: Optional[int]) -> Tuple[Table, int]:
    """The pairs of codes held by at least ``min_patient_count`` pairs, the
    ``top_k`` most frequent (``value_counts``: ties in first-seen order)."""
    values, counts = frame.value_counts(pairs[code_col])
    values = values[counts >= min_patient_count]
    if top_k is not None:
        values = values[:top_k]
    return frame.take(pairs, frame.isin(pairs[code_col], values)), len(values)


def process_diagnoses(
    diagnoses: Table,
    cohort: Table,
    collapse_to_3digit: bool = True,
    top_k: Optional[int] = None,
    min_patient_count: int = 5,
) -> Table:
    """ICD-9 codes as text (a numeric code column loses its leading zeros,
    as pandas reads it), collapsed to 3 characters; unique (patient, code)
    pairs of the cohort's admissions; frequency filtering."""
    dx = diagnoses
    if "HADM_ID" in dx and "HADM_ID" in cohort:
        dx = frame.take(dx, frame.isin(dx["HADM_ID"], cohort["HADM_ID"]))
    dx = dict(dx)
    code = frame.as_str(dx["ICD9_CODE"])
    code = frame.objects([None if c is None else c.strip() for c in code.tolist()])
    dx["ICD9_CODE"] = code
    dx = frame.take(dx, np.asarray([c is not None and c != "" and c != "nan" for c in code.tolist()], bool))
    dx["ICD3_CODE"] = (
        frame.objects([c[:3] for c in dx["ICD9_CODE"].tolist()]) if collapse_to_3digit else dx["ICD9_CODE"]
    )
    dx = frame.take(dx, frame.isin(dx["SUBJECT_ID"], cohort["SUBJECT_ID"]))
    keep = ["SUBJECT_ID", "ICD3_CODE"] + [
        c for c in ("DIAGNOSIS_CATEGORY", "DIAGNOSIS_SUBCATEGORY", "DIAGNOSIS_PRIORITY") if c in dx
    ]
    pairs = frame.select(dx, keep)
    pairs = frame.take(pairs, frame.drop_duplicates(pairs, ["SUBJECT_ID", "ICD3_CODE"]))
    pairs, n_codes = _frequent(pairs, "ICD3_CODE", min_patient_count, top_k)
    logger.info("Diagnoses: %d codes, %d pairs", n_codes, frame.nrows(pairs))
    return pairs


# -- medications --------------------------------------------------------------------

# the JAX package's patterns, as pandas runs them on its Arrow-backed strings
# (RE2): \w, \d and \b are ASCII, \s is [\t\n\f\r ]
_S = r"[\t\n\f\r ]"
_DOSE_RE = re.compile(r"\d+\.?\d*" + _S + r"*(?:mg|mcg|ml|g|%|units?)", re.ASCII)
_FORM_RE = re.compile(r"\b(?:tablet|capsule|injection|solution|suspension|syrup|cream|ointment)\b", re.ASCII)
_ROUTE_RE = re.compile(r"\b(?:oral|topical|iv|intravenous|subcutaneous)\b", re.ASCII)
_PUNCT_RE = re.compile(r"[^\w\t\n\f\r ]", re.ASCII)
_SPACE_RE = re.compile(_S + "+")


def _normalize_drug(name: str) -> str:
    s = name.lower()
    s = _DOSE_RE.sub("", s)
    s = _FORM_RE.sub("", s)
    s = _ROUTE_RE.sub("", s)
    s = _PUNCT_RE.sub(" ", s)
    s = _SPACE_RE.sub(" ", s).strip()
    return s.split(" ")[0]


def normalize_drug_names(drugs) -> np.ndarray:
    """Lower-case, strip doses / forms / routes / punctuation, keep the
    first word (usually the generic name); missing names become ``""``."""
    col = frame.as_str(np.asarray(drugs))
    done = {u: _normalize_drug(u) for u in dict.fromkeys(c for c in col.tolist() if c is not None)}
    return frame.objects(["" if c is None else done[c] for c in col.tolist()])


def normalize_drug_name(drug) -> str:
    """One drug name through :func:`normalize_drug_names`."""
    if drug is None or (isinstance(drug, float) and drug != drug):
        return ""
    return str(normalize_drug_names(frame.objects([str(drug)]))[0])


def process_medications(
    prescriptions: Table,
    cohort: Table,
    normalize_names: bool = True,
    top_k: Optional[int] = None,
    min_patient_count: int = 5,
) -> Table:
    """Drug-name normalization, unique (patient, drug) pairs of the
    cohort's admissions, frequency filtering."""
    meds = prescriptions
    if "HADM_ID" in meds and "HADM_ID" in cohort:
        meds = frame.take(meds, frame.isin(meds["HADM_ID"], cohort["HADM_ID"]))
    meds = dict(meds)
    drug = frame.objects([None if d is None else d.strip() for d in frame.as_str(meds["DRUG"]).tolist()])
    meds["DRUG"] = drug
    meds = frame.take(meds, np.asarray([d is not None and d != "" and d != "nan" for d in drug.tolist()], bool))

    drug_col = "DRUG"
    if normalize_names:
        meds["DRUG_NORM"] = normalize_drug_names(meds["DRUG"])
        meds = frame.take(meds, np.asarray([d != "" for d in meds["DRUG_NORM"].tolist()], bool))
        drug_col = "DRUG_NORM"

    meds = frame.take(meds, frame.isin(meds["SUBJECT_ID"], cohort["SUBJECT_ID"]))
    keep = ["SUBJECT_ID", drug_col] + [c for c in ("ROUTE", "FREQUENCY", "PRN", "IV_ADMIXTURE") if c in meds]
    pairs = frame.select(meds, keep)
    pairs = frame.take(pairs, frame.drop_duplicates(pairs, ["SUBJECT_ID", drug_col]))
    pairs, n_drugs = _frequent(pairs, drug_col, min_patient_count, top_k)
    pairs = {("DRUG" if k == drug_col else k): v for k, v in pairs.items()}
    logger.info("Medications: %d drugs, %d pairs", n_drugs, frame.nrows(pairs))
    return pairs


# -- demographics -------------------------------------------------------------------


def create_demographic_features(
    cohort: Table,
    include_age: bool = True,
    include_gender: bool = True,
    include_ethnicity: bool = False,
    apache: Optional[Table] = None,
) -> Table:
    """Per-patient demographic features: AGE and its z-score (ddof 1; 0
    when the spread is 0 or undefined), GENDER_M / GENDER_F from the first
    letter (NaN where the gender is missing or empty), ETH_* one-hots
    (sorted values), the APACHE scores (left merge)."""
    demo: Table = {"SUBJECT_ID": np.asarray(cohort["SUBJECT_ID"])}
    if include_age and "AGE" in cohort:
        age = to_numeric(cohort["AGE"])
        demo["AGE"] = age
        a = np.asarray(age, np.float64)
        present = a[~np.isnan(a)]
        std = present.std(ddof=1) if len(present) > 1 else np.nan
        mean = present.mean() if len(present) else np.nan
        demo["AGE_NORM"] = (a - mean) / std if std > 0 else a * 0
    if include_gender and "GENDER" in cohort:
        first = [None if s is None or s == "" else s.upper()[0] for s in frame.as_str(cohort["GENDER"]).tolist()]
        for letter in ("M", "F"):
            demo[f"GENDER_{letter}"] = np.asarray(
                [np.nan if f is None else float(f == letter) for f in first], np.float64
            )
    if include_ethnicity and "ETHNICITY" in cohort:
        eth = np.asarray(cohort["ETHNICITY"])
        miss = frame.isna(eth)
        for value in sorted(set(eth[~miss].tolist())):
            demo[f"ETH_{value}"] = np.asarray([(not m) and v == value for v, m in zip(eth.tolist(), miss)], np.float64)
    if apache is not None and frame.nrows(apache):
        cols = [c for c in ("SUBJECT_ID", "acutephysiologyscore", "apachescore") if c in apache]
        scores = frame.select(apache, cols)
        scores = frame.take(scores, frame.drop_duplicates(scores, ["SUBJECT_ID"]))
        demo = frame.merge(demo, scores, on=["SUBJECT_ID"], how="left")
    return demo


# -- the stage ----------------------------------------------------------------------


def preprocess_pipeline(config: Config, interim_dir=None, raw_dir=None) -> Dict[str, Table]:
    """Load raw data (eICU, MIMIC-III or the synthetic cohort, as
    ``data.dataset`` says), select the cohort, process every modality, and
    with ``interim_dir`` write the interim tables there: ``cohort``,
    ``labs_normalized``, ``diagnoses``, ``medications``, ``demographics``,
    ``labitems`` and ``normalizer`` (the synthetic route writes the
    generator's tables)."""
    dataset = config.data.dataset
    if dataset == "synthetic":
        tables = generate_synthetic_tables(spec_from_config(config))
        _write_interim(tables, interim_dir)
        return tables

    fs = config.feature_space
    cohort_cfg = {
        "age_min": config.cohort.age_min,
        "age_max": config.cohort.age_max,
        "use_first_icu_only": config.cohort.use_first_icu_only,
        "subject_limit": config.cohort.subject_limit,
        "min_los_hours": config.cohort.min_los_hours,
        "exclude_deaths": config.cohort.exclude_deaths,
    }
    raw_dir = Path(raw_dir or config.data.raw_dir)
    from multi_modal_gnn_tpu_torch.data import eicu, mimic

    if dataset == "eicu":
        loader = eicu.EICULoader(raw_dir)
        cohort = eicu.select_cohort(loader.load_patients(), **cohort_cfg)
        labevents = loader.load_labevents()
        apache = loader.load_apache_for_cohort(cohort) if _has_apache(loader) else None
    elif dataset == "mimic3":
        loader = mimic.MIMICLoader(raw_dir)
        cohort = mimic.select_cohort(
            loader.load_patients(), loader.load_admissions(), loader.load_icustays(), **cohort_cfg
        )
        if config.data.labevents_chunksize:
            labevents = loader.load_labevents_for_cohort(
                cohort["SUBJECT_ID"], chunksize=config.data.labevents_chunksize
            )
        else:
            labevents = loader.load_labevents()
        apache = None
    else:
        raise ValueError(f"Unknown dataset: {dataset}")
    d_labitems = loader.load_d_labitems()
    diagnoses = loader.load_diagnoses_icd()
    prescriptions = loader.load_prescriptions()

    labs, labitems = mimic.filter_labs_for_cohort(
        labevents, cohort, d_labitems, top_k=fs.labs.top_k, min_patient_count=fs.labs.min_patient_count,
    )
    labs_agg = aggregate_lab_values(
        labs, cohort,
        method=fs.labs.aggregate,
        remove_outliers_flag=fs.labs.outlier_std_threshold is not None,
        outlier_threshold=fs.labs.outlier_std_threshold or 5.0,
    )
    labs_norm, normalizer = normalize_lab_values(labs_agg, method=fs.labs.normalize)
    dx = process_diagnoses(
        diagnoses, cohort,
        collapse_to_3digit=fs.diagnoses.collapse_to_3digit,
        top_k=fs.diagnoses.top_k,
        min_patient_count=fs.diagnoses.min_patient_count,
    )
    rx = process_medications(
        prescriptions, cohort,
        normalize_names=fs.medications.normalize_names,
        top_k=fs.medications.top_k,
        min_patient_count=fs.medications.min_patient_count,
    )
    demo = create_demographic_features(
        cohort,
        include_age=fs.demographics.include_age,
        include_gender=fs.demographics.include_gender,
        include_ethnicity=fs.demographics.include_ethnicity,
        apache=apache,
    )
    cohort_out = frame.select(cohort, [c for c in ("SUBJECT_ID", "HADM_ID", "AGE", "GENDER", "ETHNICITY")
                                       if c in cohort])
    tables = {
        "cohort": cohort_out,
        "labs_normalized": labs_norm,
        "diagnoses": dx,
        "medications": rx,
        "demographics": demo,
        "labitems": labitems,
        "normalizer": normalizer.to_frame(),
    }
    _write_interim(tables, interim_dir)
    return tables


def _has_apache(loader) -> bool:
    try:
        loader.load_apache()
        return True
    except FileNotFoundError:
        return False


def _write_interim(tables: Dict[str, Table], interim_dir) -> None:
    if interim_dir is None:
        return
    interim = Path(interim_dir)
    for name, table in tables.items():
        save_table(table, interim / f"{name}.npz")
    logger.info("Wrote interim tables to %s", interim)
