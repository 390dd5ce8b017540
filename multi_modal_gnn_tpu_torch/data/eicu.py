"""eICU Collaborative Research Database loader (``multi_modal_gnn_tpu/data/eicu.py``)
on numpy tables: the tables, their MIMIC-format views, cohort selection.

Schema notes (as the JAX package's):
  * SUBJECT_ID := patientunitstayid (one graph node per ICU stay);
  * ITEMID := labname (eICU has no numeric lab IDs: lab IDs are strings);
  * HADM_ID := patienthealthsystemstayid;
  * age ``'> 89'`` reads as 90;
  * diagnoses: the first code of the comma-separated icd9code list, the
    hierarchical diagnosisstring where there is none.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from multi_modal_gnn_tpu_torch.utils import frame
from multi_modal_gnn_tpu_torch.utils.csv_table import read_csv, to_datetime, to_numeric
from multi_modal_gnn_tpu_torch.utils.frame import Table

logger = logging.getLogger(__name__)


def _fill(col: np.ndarray, default) -> np.ndarray:
    """``fillna(default)``."""
    miss = frame.isna(col)
    if not miss.any():
        return col
    if col.dtype.kind == "f" and isinstance(default, (int, float)):
        out = col.copy()
        out[miss] = default
        return out
    out = np.asarray(col).astype(object)
    out[miss] = default
    return out


def _column_or_none(table: Table, name: str) -> np.ndarray:
    """``table.get(name)`` as pandas assigns it: the column, or missing
    values where there is none."""
    return table[name] if name in table else frame.objects([None] * frame.nrows(table))


class EICULoader:
    """Loads eICU ``.csv.gz`` (or ``.csv``) tables and exposes MIMIC-format
    views."""

    def __init__(self, data_dir: Union[str, Path]):
        self.data_dir = Path(data_dir)
        if not self.data_dir.exists():
            raise FileNotFoundError(f"Data directory not found: {self.data_dir}")
        self._cache: Dict[str, Table] = {}

    def _load_csv(self, table_name: str) -> Table:
        if table_name in self._cache:
            return self._cache[table_name]
        path = self.data_dir / f"{table_name}.csv.gz"
        if not path.exists():
            alt = self.data_dir / f"{table_name}.csv"
            if not alt.exists():
                raise FileNotFoundError(f"CSV file not found: {path}")
            path = alt
        table = read_csv(path)
        logger.info("Loaded %s: %s rows", table_name, f"{frame.nrows(table):,}")
        self._cache[table_name] = table
        return table

    def load_table(self, table_name: str) -> Table:
        return self._load_csv(table_name)

    def load_patients(self) -> Table:
        return self._load_csv("patient")

    def load_lab(self) -> Table:
        return self._load_csv("lab")

    def load_diagnosis(self) -> Table:
        return self._load_csv("diagnosis")

    def load_medication(self) -> Table:
        return self._load_csv("medication")

    def load_apache(self) -> Table:
        return self._load_csv("apachePatientResult")

    # -- MIMIC-format views -------------------------------------------------

    def load_labevents(self) -> Table:
        """Lab results as SUBJECT_ID / ITEMID (the lab name) / VALUENUM /
        CHARTTIME (the result offset in minutes)."""
        labs = self.load_lab()
        return {
            "SUBJECT_ID": labs["patientunitstayid"],
            "ITEMID": labs["labname"],
            "VALUENUM": to_numeric(labs["labresult"]),
            "CHARTTIME": labs["labresultoffset"],
        }

    def _stay_to_hospital_stay(self) -> Table:
        p = frame.select(self.load_patients(), ("patientunitstayid", "patienthealthsystemstayid"))
        return frame.take(p, frame.drop_duplicates(p, list(p)))

    def load_diagnoses_icd(self) -> Table:
        """Diagnoses as SUBJECT_ID / ICD9_CODE / HADM_ID with the
        diagnosisstring's first two levels."""
        dx = self.load_diagnosis()
        codes = [None if s is None else s.split(",")[0].strip() for s in frame.as_str(dx["icd9code"])]
        dxs = dx["diagnosisstring"]
        icd9 = frame.objects(codes)
        miss = frame.isna(icd9)
        if miss.any():  # fillna(diagnosisstring)
            icd9[miss] = np.asarray(dxs, dtype=object)[miss]
            icd9[frame.isna(icd9)] = None
        parts = [None if s is None else s.split("|") for s in frame.as_str(dxs)]
        out = {
            "SUBJECT_ID": dx["patientunitstayid"],
            "ICD9_CODE": icd9,
            "diagnosisstring": dxs,
            "patientunitstayid": dx["patientunitstayid"],
            "DIAGNOSIS_CATEGORY": frame.objects(["Unknown" if p is None else p[0].strip() for p in parts]),
            # rows with fewer than two levels: "Unknown"
            "DIAGNOSIS_SUBCATEGORY": frame.objects(
                ["Unknown" if p is None or len(p) < 2 else p[1].strip() for p in parts]
            ),
        }
        if "diagnosispriority" in dx:
            out["DIAGNOSIS_PRIORITY"] = _fill(dx["diagnosispriority"], "Other")
        return self._with_hadm(out)

    def _with_hadm(self, out: Table) -> Table:
        out = frame.merge(out, self._stay_to_hospital_stay(), on=["patientunitstayid"], how="left")
        out["HADM_ID"] = out.pop("patienthealthsystemstayid")
        del out["patientunitstayid"]
        return out

    def load_prescriptions(self) -> Table:
        """Medications as SUBJECT_ID / DRUG / HADM_ID with the
        administration fields."""
        rx = self.load_medication()
        out = {
            "SUBJECT_ID": rx["patientunitstayid"],
            "DRUG": rx["drugname"],
            "patientunitstayid": rx["patientunitstayid"],
        }
        n = frame.nrows(rx)
        for src, dst, default in (
            ("routeadmin", "ROUTE", "Unknown"),
            ("frequency", "FREQUENCY", "Unknown"),
            ("prn", "PRN", "No"),
            ("drugivadmixture", "IV_ADMIXTURE", "No"),
            ("dosage", "DOSAGE", ""),
        ):
            out[dst] = _fill(rx[src], default) if src in rx else frame.objects([default] * n)
        return self._with_hadm(out)

    def load_apache_for_cohort(self, cohort: Table) -> Table:
        apache = self.load_apache()
        cols = ["patientunitstayid", "acutephysiologyscore", "apachescore", "predictedicumortality",
                "predictedhospitalmortality"]
        out = {c: apache[c] for c in cols if c in apache}
        out["SUBJECT_ID"] = out["patientunitstayid"]
        return out

    def load_d_labitems(self) -> Table:
        """The lab dictionary, made from the lab table's distinct lab names
        (in first-seen order)."""
        names = self.load_lab()["labname"]
        names = names[~frame.isna(names)]
        uniq = frame.objects(list(dict.fromkeys(names.tolist())))
        return {
            "ITEMID": uniq, "LABEL": uniq.copy(),
            "FLUID": frame.objects(["Blood"] * len(uniq)), "CATEGORY": frame.objects(["Chemistry"] * len(uniq)),
        }


def map_eicu_to_mimic_format(loader: EICULoader) -> Dict[str, Table]:
    """Every eICU table mapped to the MIMIC-III-style contract."""
    patients = dict(loader.load_patients())
    patients["SUBJECT_ID"] = patients["patientunitstayid"]
    patients["GENDER"] = _column_or_none(patients, "gender")
    patients["AGE"] = parse_eicu_age(patients["age"])

    admissions = dict(loader.load_patients())
    admissions["SUBJECT_ID"] = admissions["patientunitstayid"]
    admissions["HADM_ID"] = admissions["patienthealthsystemstayid"]
    return {
        "patients": patients,
        "admissions": admissions,
        "labevents": loader.load_labevents(),
        "labitems": loader.load_d_labitems(),
        "diagnoses": loader.load_diagnoses_icd(),
        "prescriptions": loader.load_prescriptions(),
    }


def parse_eicu_age(age) -> np.ndarray:
    """``'> 89'`` -> 90, numbers as numbers (strings stripped), else NaN:
    int64 where every age is a whole number and none is missing, else
    float64."""
    text = [None if s is None else s.strip() for s in frame.as_str(np.asarray(age))]
    text = ["90" if s == "> 89" else s for s in text]
    return to_numeric(frame.objects(text))


def select_cohort(
    patients: Table,
    age_min: int = 18,
    age_max: Optional[int] = None,
    use_first_icu_only: bool = True,
    subject_limit: Optional[int] = None,
    min_los_hours: Optional[float] = None,
    exclude_deaths: bool = False,
    **_unused,
) -> Table:
    """Cohort selection on the eICU patient table: the age band, LOS and
    survival filters, the first stay per ``uniquepid`` by unit admit time
    (``unitadmittime24`` as a time of day; whole rows), ``subject_limit``."""
    cohort = dict(patients)
    cohort["AGE"] = parse_eicu_age(cohort["age"])
    with np.errstate(invalid="ignore"):
        keep = np.asarray(cohort["AGE"], np.float64) >= age_min
        if age_max is not None:
            keep &= np.asarray(cohort["AGE"], np.float64) <= age_max
    cohort = frame.take(cohort, keep)
    logger.info("After age filter [%s, %s]: %d stays", age_min, age_max, frame.nrows(cohort))

    # unit discharge offset is minutes from unit admission
    if "unitdischargeoffset" in cohort:
        cohort["LOS_HOURS"] = np.asarray(cohort["unitdischargeoffset"], np.float64) / 60.0
        if min_los_hours is not None:
            cohort = frame.take(cohort, cohort["LOS_HOURS"] >= min_los_hours)
            logger.info("After LOS >= %sh: %d stays", min_los_hours, frame.nrows(cohort))

    if exclude_deaths and "unitdischargestatus" in cohort:
        status = np.asarray(cohort["unitdischargestatus"], dtype=object)
        cohort = frame.take(cohort, np.asarray([s == "Alive" for s in status.tolist()], bool))
        logger.info("After excluding deaths: %d stays", frame.nrows(cohort))

    if use_first_icu_only:
        admit = to_datetime(_column_or_none(cohort, "unitadmittime24").astype(object), fmt="%H:%M:%S")
        keyed = {"uniquepid": cohort["uniquepid"], "_admit": admit}
        cohort = frame.take(cohort, frame.sort_order(keyed, ["uniquepid", "_admit"]))
        cohort = frame.take(cohort, frame.drop_duplicates(cohort, ["uniquepid"]))
        logger.info("After first-stay-per-patient: %d patients", frame.nrows(cohort))

    if subject_limit is not None and subject_limit < frame.nrows(cohort):
        cohort = frame.take(cohort, slice(0, subject_limit))

    cohort["SUBJECT_ID"] = cohort["patientunitstayid"]
    cohort["HADM_ID"] = cohort["patienthealthsystemstayid"]
    cohort["GENDER"] = _column_or_none(cohort, "gender")
    logger.info("Final eICU cohort: %d", frame.nrows(cohort))
    return cohort


def validate_eicu_data(loader: EICULoader) -> Dict[str, int]:
    """Completeness statistics of the raw tables."""
    patients = loader.load_patients()
    labs = loader.load_lab()
    dx = loader.load_diagnosis()
    rx = loader.load_medication()

    def nunique(col):
        present = np.asarray(col)[~frame.isna(col)]
        return len(frame.value_counts(present)[0])

    stats = {
        "n_patient_stays": frame.nrows(patients),
        "n_unique_patients": nunique(patients["uniquepid"]),
        "missing_gender": int(frame.isna(patients["gender"]).sum()),
        "missing_age": int(frame.isna(patients["age"]).sum()),
        "n_lab_results": frame.nrows(labs),
        "n_unique_lab_types": nunique(labs["labname"]),
        "missing_lab_values": int(frame.isna(labs["labresult"]).sum()),
        "n_diagnoses": frame.nrows(dx),
        "n_unique_diagnosis_strings": nunique(dx["diagnosisstring"]),
        "n_medications": frame.nrows(rx),
        "n_unique_drugs": nunique(rx["drugname"]),
    }
    for k, v in stats.items():
        logger.info("  %s: %s", k, f"{v:,}")
    return stats
