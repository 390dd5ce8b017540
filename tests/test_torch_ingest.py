"""PyTorch port: the raw-data ingest path against the JAX package's.

Small eICU and MIMIC-III raw directories are written here with numpy and
``csv`` (``.csv.gz`` and lower-case file names among them), with a row for
each place where pandas' semantics decide the result: a NaT CHARTTIME that
wins ``last``, CHARTTIME ties decided by file order, stays merged in file
order, INTIME sorted as written, ages over 89, a date of another format,
a lab with one observation, an outlier, quoted commas, a numeric ICD-9
column that loses its leading zeros, ``icd9code`` lists and
``diagnosisstring`` levels.  The port's loaders, ``select_cohort`` and
``preprocess_pipeline`` are held to JAX's (pandas here) table by table:
ints and strings exact, floats within 1e-12 relative, JAX's row order,
the normalizer table included; the graph built from each package's
interim tables equal, array by array.
"""

import csv
import datetime as dt
import gzip
import json
import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data import eicu as jax_eicu
from multi_modal_gnn_tpu.data import mimic as jax_mimic
from multi_modal_gnn_tpu.data import preprocess as jax_pre
from multi_modal_gnn_tpu.graph.build import build_graph_from_preprocessed as jax_build_graph
from multi_modal_gnn_tpu.utils import normalizer as jax_norm

from multi_modal_gnn_tpu_torch import native
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import eicu, mimic
from multi_modal_gnn_tpu_torch.data import preprocess as pre
from multi_modal_gnn_tpu_torch.graph.build import build_graph_from_preprocessed
from multi_modal_gnn_tpu_torch.ops import _build
from multi_modal_gnn_tpu_torch.utils import csv_table, frame
from multi_modal_gnn_tpu_torch.utils import normalizer as norm
from test_torch_plans import assert_graphs_equal

REL = 1e-12
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def graphcore():
    """The graph core, built once (under its lock); these tests need a C++
    compiler as the kernel tests need a card."""
    if _build.cxx() is None:
        pytest.skip("no C++ compiler to build csrc/graphcore.cpp")
    native.load()


# -- comparison ------------------------------------------------------------------------


def _py(v):
    """A comparable Python value: None where missing, datetimes as
    microseconds, numpy scalars as Python ones."""
    if isinstance(v, (pd.Timestamp, np.datetime64, dt.datetime)):
        t = pd.Timestamp(v)
        return None if pd.isna(t) else ("datetime", int(t.asm8.astype("datetime64[us]").astype(np.int64)))
    if v is None or v is pd.NA or v is pd.NaT:
        return None
    if isinstance(v, (float, np.floating)) and np.isnan(v):
        return None
    if isinstance(v, np.generic):
        return v.item()
    return v


def _values(col):
    if isinstance(col, pd.Series):
        return [_py(v) for v in col.astype(object).tolist()]
    return [_py(v) for v in np.asarray(col).tolist()] if np.asarray(col).dtype.kind != "M" else [
        _py(v) for v in np.asarray(col)
    ]


def assert_column_equal(name, got, want):
    g, w = _values(got), _values(want)
    assert len(g) == len(w), f"{name}: {len(g)} rows, JAX {len(w)}"
    for i, (a, b) in enumerate(zip(g, w)):
        if a is None or b is None:
            assert a is None and b is None, f"{name}[{i}]: {a!r} vs JAX {b!r}"
        elif isinstance(b, str) or isinstance(a, str) or isinstance(b, tuple):
            assert a == b, f"{name}[{i}]: {a!r} vs JAX {b!r}"
        elif isinstance(b, (bool, np.bool_)) or isinstance(a, bool):
            assert bool(a) == bool(b) and type(a) is type(b), f"{name}[{i}]: {a!r} vs JAX {b!r}"
        elif isinstance(a, int) and isinstance(b, int):
            assert a == b, f"{name}[{i}]: {a} vs JAX {b}"
        else:
            assert a == b or abs(a - b) <= REL * max(abs(a), abs(b)), f"{name}[{i}]: {a!r} vs JAX {b!r}"


def assert_table_equal(got, want: pd.DataFrame, label=""):
    assert list(got) == list(want.columns), f"{label}: columns {list(got)} vs JAX {list(want.columns)}"
    for name in want.columns:
        assert_column_equal(f"{label}.{name}", got[name], want[name])


# -- raw fixtures ----------------------------------------------------------------------


def write_csv(path: Path, header, rows):
    """``rows`` as CSV with the ``csv`` module (``.gz``: gzip); None is an
    empty field, strings with commas are quoted."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wt", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([["" if v is None else v for v in r] for r in rows])


def _ts(base: dt.datetime, hours: float) -> str:
    return (base + dt.timedelta(hours=float(hours))).strftime("%Y-%m-%d %H:%M:%S")


def make_mimic_dir(root: Path, numeric_icd: bool = False, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    dobs = {
        1: "2080-03-15 00:00:00",  # birthday after the admission: 69, not 70
        2: "1850-01-01 00:00:00",  # date-shifted: 300 years -> 91.4
        3: "2100-06-01 00:00:00",
        4: "2140-01-01 00:00:00",  # 10: under age
        5: None,  # no DOB: NaT, no age
        6: "2090-01-01 00:00:00", 7: "2095-05-05 00:00:00", 8: "2070-12-31 00:00:00",
        9: "2085-07-07 00:00:00",  # no ICU stay
        10: "2101-02-28 00:00:00", 11: "2099-09-09 00:00:00", 12: "2098-01-01 00:00:00",
        13: "2060-01-01 00:00:00", 14: "2061-01-01 00:00:00",
    }
    genders = {1: "M", 2: "F", 3: "M", 4: None, 5: "f", 6: "M", 7: "F", 8: "M", 9: "F", 10: "M", 11: "F",
               12: "M", 13: "", 14: "F"}
    write_csv(root / "patients.csv", ["ROW_ID", "SUBJECT_ID", "GENDER", "DOB", "EXPIRE_FLAG"],
              [[i, s, genders[s], dobs[s], int(s == 3)] for i, s in enumerate(dobs)])
    admit = {s: "2150-03-10 08:00:00" for s in dobs}
    admit[12] = "2150-03-10"  # another format than the first value's: NaT, as to_datetime reads it
    eth = {s: ["WHITE", "BLACK", "HISPANIC, LATINO", None][s % 4] for s in dobs}
    adm_rows = [[i, s, 100 + s, admit[s], "2150-03-20 08:00:00", eth[s], int(s == 3)] for i, s in enumerate(dobs)]
    adm_rows.append([99, 6, 206, "2150-03-11 08:00:00", "2150-03-12 08:00:00", "WHITE", 0])
    write_csv(root / "ADMISSIONS.csv.gz",
              ["ROW_ID", "SUBJECT_ID", "HADM_ID", "ADMITTIME", "DISCHTIME", "ETHNICITY", "HOSPITAL_EXPIRE_FLAG"],
              adm_rows)
    # stays in no subject order; subject 7's INTIME "10:00" sorts before "9:00" as written
    stays = [
        (7, 107, 3007, "2150-03-10 9:00:00", 2.5), (1, 101, 3001, "2150-03-10 10:00:00", 1.0),
        (6, 106, 3006, "2150-03-12 10:00:00", 3.0), (6, 206, 3016, "2150-03-11 10:00:00", 0.5),
        (7, 107, 3017, "2150-03-10 10:00:00", 1.5), (2, 102, 3002, "2150-03-10 11:00:00", 4.0),
        (3, 103, 3003, "2150-03-10 12:00:00", 0.8), (4, 104, 3004, "2150-03-10 12:00:00", 2.0),
        (5, 105, 3005, "2150-03-10 12:00:00", 2.0), (8, 108, 3008, None, 2.0),
        (8, 108, 3018, "2150-03-10 13:00:00", 2.2), (10, 110, 3010, "2150-03-10 14:00:00", 5.0),
        (11, 999, 3011, "2150-03-10 14:00:00", 5.0),  # no such admission: the inner merge drops it
        (12, 112, 3012, "2150-03-10 14:00:00", 1.2), (1, 101, 3001, "2150-03-10 10:00:00", 1.0),
        (13, 113, 3013, "2150-03-10 15:00:00", 3.3), (14, 114, 3014, "2150-03-10 15:00:00", 0.9),
    ]
    write_csv(root / "icustays.csv", ["ROW_ID", "SUBJECT_ID", "HADM_ID", "ICUSTAY_ID", "INTIME", "OUTTIME", "LOS"],
              [[i, s, h, icu, t, "2150-03-15 00:00:00", los] for i, (s, h, icu, t, los) in enumerate(stays)])

    base = dt.datetime(2150, 3, 10)
    rows = []
    subjects = [1, 2, 3, 6, 7, 8, 9, 10, 12, 13, 14]
    for item, center, n_subj in ((50001, 100.0, 11), (50002, 10.0, 11), (50003, 4.0, 7), (50004, 1.0, 7),
                                 (50005, 40.0, 5)):
        for s in subjects[:n_subj]:
            for _ in range(int(rng.integers(2, 6))):
                v = round(float(center + center * 0.1 * rng.standard_normal()), 3)
                rows.append([s, 100 + s, item, _ts(base, int(rng.integers(0, 48))), str(v), v, "mg/dL", None])
    rows.append([1, 101, 50002, _ts(base, 3), "1e6", 1e6, "mg/dL", "abnormal"])  # 5 sigma: removed
    rows.append([1, 101, 50001, _ts(base, 60), "90", 90.0, "mg/dL", None])  # a tie at hour 60 ...
    rows.append([1, 101, 50001, _ts(base, 60), "91", 91.0, "mg/dL", None])  # ... the file's order decides
    rows.append([2, 102, 50001, None, "77", 77.0, "mg/dL", None])  # NaT sorts last: it wins
    rows.append([3, 103, 50003, _ts(base, 5), "NEG", None, None, None])  # no VALUENUM
    rows.append([3, 103, 50003, _ts(base, 6), "1,000", 1000.0, "mg/dL", "abnormal"])  # a quoted comma
    rows.append([6, 106, 50006, _ts(base, 7), "3.3", 3.3, "U/L", None])  # one observation: scale 0
    order = rng.permutation(len(rows))
    write_csv(root / "LABEVENTS.csv.gz",
              ["ROW_ID", "SUBJECT_ID", "HADM_ID", "ITEMID", "CHARTTIME", "VALUE", "VALUENUM", "VALUEUOM", "FLAG"],
              [[i, *rows[j]] for i, j in enumerate(order)])
    write_csv(root / "d_labitems.csv", ["ROW_ID", "ITEMID", "LABEL", "FLUID", "CATEGORY", "LOINC_CODE"],
              [[i, 50001 + i, ["Glucose", "Potassium, Whole Blood", "Lactate", "Creatinine", "Sodium", "Lipase",
                              "Unused"][i], "Blood", "Chemistry", None if i % 2 else f"{1000 + i}-1"]
               for i in range(7)])
    if numeric_icd:  # an all-digit column reads as int: "0389" becomes 389
        codes = ["4019", "0389", "25000", "0389", "5849", "4280", "0040", "99591"]
    else:
        codes = ["4019", "V3001", "E8791", "0389", "5849", None, "4280", "V3001"]
    dx_rows = []
    for s in subjects + [11]:
        for k in range(int(rng.integers(1, 5))):
            dx_rows.append([len(dx_rows), s, 100 + s, k + 1, codes[int(rng.integers(0, len(codes)))]])
    dx_rows.append([len(dx_rows), 6, 206, 1, codes[1]])
    write_csv(root / "DIAGNOSES_ICD.csv", ["ROW_ID", "SUBJECT_ID", "HADM_ID", "SEQ_NUM", "ICD9_CODE"], dx_rows)
    drugs = ["Aspirin 81 mg Tablet", "Heparin, Porcine 5000 units", "Insulin", "NS", "Vancomycin 1 g IV",
             None, "0.9% Sodium Chloride", "D5W", "Metoprolol Tartrate 25mg Oral", "Potassium Chloride"]
    rx_rows = []
    for s in subjects + [11]:
        for _ in range(int(rng.integers(1, 6))):
            rx_rows.append([len(rx_rows), s, 100 + s, drugs[int(rng.integers(0, len(drugs)))], "MAIN",
                            ["PO", "IV", None][int(rng.integers(0, 3))]])
    write_csv(root / "PRESCRIPTIONS.csv", ["ROW_ID", "SUBJECT_ID", "HADM_ID", "DRUG", "DRUG_TYPE", "ROUTE"], rx_rows)
    return root


def make_eicu_dir(root: Path, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    pats = [
        (1001, 2001, "A", "Male", "45", 2880, "Alive", "10:00:00"),
        (1002, 2002, "A", "Male", "46", 1440, "Alive", "08:00:00"),  # A's earlier stay
        (1003, 2003, "B", "Female", "> 89", 4320, "Alive", "12:00:00"),
        (1004, 2004, "C", "Male", "17", 1440, "Alive", "09:00:00"),
        (1005, 2005, "D", None, "70", 720, "Expired", "11:00:00"),
        (1006, 2006, "E", "Female", "bad", 600, "Alive", "11:00:00"),
        (1007, 2007, "F", "Female", "60", 3000, "Alive", None),  # no admit time: sorts last
        (1008, 2008, "F", "Female", "61", 3000, "Alive", "07:00:00"),
        (1009, 2009, "G", "", None, 100, "Alive", "06:00:00"),
        (1010, 2010, "H", "Male", "55", 5000, "Alive", "05:00:00"),
    ]
    write_csv(root / "patient.csv.gz",
              ["patientunitstayid", "patienthealthsystemstayid", "uniquepid", "gender", "age", "unitdischargeoffset",
               "unitdischargestatus", "unitadmittime24"], pats)
    rows = []
    for pid in (1001, 1002, 1003, 1005, 1007, 1008, 1010):
        for lab, base in (("glucose", 100.0), ("sodium", 140.0), ("WBC x 1000", 8.0), ("BUN", 20.0)):
            for _ in range(int(rng.integers(1, 4))):
                v = round(float(base + base * 0.05 * rng.standard_normal()), 2)
                rows.append([pid, int(rng.integers(0, 5)) * 60, lab, v])
    rows.append([1001, 600, "glucose", "pending"])  # not a number: NaN
    rows.append([1002, None, "sodium", 150.0])  # no offset: sorts last, wins
    rows.append([1003, 60, None, 5.0])  # no lab name: in no group
    rows.append([1010, 30, "troponin", 0.04])  # one observation
    write_csv(root / "lab.csv.gz", ["patientunitstayid", "labresultoffset", "labname", "labresult"],
              [rows[j] for j in rng.permutation(len(rows))])
    dx = [
        (1001, 10, "cardiovascular|shock / hypotension|sepsis", "785.52, 995.92", "Primary"),
        (1001, 20, "pulmonary|respiratory failure|ARDS", None, "Major"),
        (1002, 30, "cardiovascular|chest pain / ASHD|acute coronary syndrome", "411.1", None),
        (1003, 40, "renal|electrolyte imbalance|hyponatremia", "276.1", "Other"),
        (1005, 50, "renal", None, "Primary"),  # one level: subcategory Unknown
        (1007, 60, None, "250.00", "Primary"),
        (1008, 60, "endocrine| diabetes |", "250.01, 250.02", "Major"),
        (1010, 70, "pulmonary|respiratory failure|ARDS", "518.81", "Primary"),
        (1010, 80, "pulmonary|respiratory failure|ARDS", "518.82", "Primary"),
    ]
    write_csv(root / "diagnosis.csv.gz",
              ["patientunitstayid", "diagnosisoffset", "diagnosisstring", "icd9code", "diagnosispriority"], dx)
    meds = [
        (1001, 5, "ASPIRIN 81 MG PO TABS", "81", "PO", "Daily", "No", "No"),
        (1001, 10, "Heparin Sodium 5000 units", "5000", "SC", None, "No", "No"),
        (1003, 15, "aspirin ec 325mg", "325", "PO", "Daily", "Yes", None),
        (1005, 20, "NOREPINEPHRINE 8 MG", "8", None, "Daily", "No", "No"),
        (1005, 25, "Heparin 5000units injection", None, "SC", "Daily", "No", "No"),
        (1008, 30, "insulin, regular", "4", "SC", "PRN", "Yes", "No"),
        (1010, 35, None, "1", "PO", "Daily", "No", "No"),
    ]
    write_csv(root / "medication.csv.gz",
              ["patientunitstayid", "drugstartoffset", "drugname", "dosage", "routeadmin", "frequency", "prn",
               "drugivadmixture"], meds)
    write_csv(root / "apachePatientResult.csv",
              ["patientunitstayid", "acutephysiologyscore", "apachescore", "predictedicumortality"],
              [(1001, 40, 50, 0.1), (1003, 60, 70, 0.3), (1003, 61, 71, 0.31), (1008, 20, 25, 0.02)])
    return root


@pytest.fixture(scope="module")
def mimic_dir(tmp_path_factory):
    return make_mimic_dir(tmp_path_factory.mktemp("mimic"))


@pytest.fixture(scope="module")
def eicu_dir(tmp_path_factory):
    return make_eicu_dir(tmp_path_factory.mktemp("eicu"))


def _configs(dataset, raw, tmp, **overrides):
    """The port's config and the same config in the JAX package."""
    d = Config().to_dict()
    d["data"].update(dataset=dataset, raw_dir=str(raw), interim_dir=str(tmp / "interim"), output_dir=str(tmp / "out"))
    fs = d["feature_space"]
    for section in ("labs", "diagnoses", "medications"):
        fs[section].update(top_k=4, min_patient_count=1)
    fs["demographics"]["include_ethnicity"] = True
    for section, values in overrides.items():
        for key, value in values.items():
            if isinstance(value, dict):
                d[section][key].update(value)
            else:
                d[section][key] = value
    return Config.from_dict(d), JaxConfig.from_dict(d)


# -- the CSV reader and the date parser ------------------------------------------------


def test_read_csv_types_equal_pandas(tmp_path):
    text = (
        "a,B,c,d,e,f,g,h,i,j\n"
        '1,0015," x, y ",,1.5,True,2150-01-01,+5,A,99999999999999999999\n'
        '2,0123,"",NA,2,False,,-3,,4\n'
        '3,0999,z,n/a,inf,TRUE,2150-01-01 05:00:00,7,null,5\n'
        "\n"
        '4,7,"q ""r""",#N/A,1e3,false,x, 30 ,None,6\n'
    )
    for name, writer in (("t.csv", open), ("t.csv.gz", gzip.open)):
        with writer(tmp_path / name, "wt", newline="") as f:
            f.write(text)
        got = csv_table.read_csv(tmp_path / name)
        want = pd.read_csv(tmp_path / name)
        assert_table_equal(got, want, name)
        kinds = {"i": "i", "f": "f", "b": "b", "O": "O"}
        for col in want.columns:
            assert got[col].dtype.kind == kinds.get(want[col].dtype.kind, "O"), col
    upper = csv_table.read_csv(tmp_path / "t.csv", upper=True)
    assert list(upper) == [c.upper() for c in want.columns]


@pytest.mark.parametrize(
    "values,fmt",
    [
        (["2150-01-01 05:00:00", "2150-01-02", None, "bad", "2150-02-30 01:00:00", "2150-1-5 3:04:05"], None),
        (["2150-01-05", "2150-01-05 06:00:00", "2150-1-5", "", "2151-12-31"], None),
        (["2150-01-05T05:00:00", "2150-01-05 06:00:00", "2150-01-05T07:08:09"], None),
        (["bad", "2150-01-05", "01/02/2150"], None),
        (["08:00:00", "8:00:00", "x", None, "23:59:59"], "%H:%M:%S"),
        (["1600-01-01 00:00:00", "2300-06-15 12:00:00"], None),
    ],
)
def test_to_datetime_equals_pandas(values, fmt):
    col = np.asarray(values, dtype=object)
    with pytest.warns(UserWarning) if values[0] == "bad" else _nullcontext():
        want = pd.to_datetime(pd.Series(values, dtype=object), format=fmt, errors="coerce")
    assert_column_equal("to_datetime", csv_table.to_datetime(col, fmt=fmt), want)


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# -- MIMIC-III ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", ["PATIENTS", "ADMISSIONS", "ICUSTAYS", "D_LABITEMS", "DIAGNOSES_ICD",
                                   "PRESCRIPTIONS"])
def test_mimic_tables_equal_jax(mimic_dir, table):
    assert_table_equal(mimic.MIMICLoader(mimic_dir).load_table(table),
                       jax_mimic.MIMICLoader(mimic_dir).load_table(table), table)


def test_mimic_labevents_scan_equals_jax(mimic_dir):
    ours, theirs = mimic.MIMICLoader(mimic_dir), jax_mimic.MIMICLoader(mimic_dir)
    ids = np.asarray([1, 2, 3, 6, 7, 8, 10, 12, 13, 14])
    want = theirs.load_labevents_for_cohort(ids, chunksize=7)  # pandas' chunks or JAX's native scan
    got = ours.load_labevents_for_cohort(ids)
    want["CHARTTIME"] = pd.to_datetime(want["CHARTTIME"], errors="coerce")
    assert_table_equal(got, want[["SUBJECT_ID", "ITEMID", "VALUENUM", "CHARTTIME"]], "scan")
    assert_table_equal(ours.load_labevents_for_cohort_plain(ids, chunksize=7), want[list(got)], "chunked")
    # the whole table: the rows with a VALUENUM, as pandas' read filtered
    full = theirs.load_labevents()
    full = full[full["VALUENUM"].notna()].reset_index(drop=True)
    assert_table_equal(ours.load_labevents(), full[["SUBJECT_ID", "ITEMID", "VALUENUM", "CHARTTIME"]], "all")
    assert frame.nrows(ours.load_labevents_for_cohort([])) == 0


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"use_first_icu_only": False},
        {"subject_limit": 4, "exclude_deaths": True},
        {"min_los_hours": 30.0, "age_max": 91},
        {"age_min": 0, "age_max": 60},
    ],
)
def test_mimic_select_cohort_equals_jax(mimic_dir, kwargs):
    ours, theirs = mimic.MIMICLoader(mimic_dir), jax_mimic.MIMICLoader(mimic_dir)
    got = mimic.select_cohort(ours.load_patients(), ours.load_admissions(), ours.load_icustays(), **kwargs)
    want = jax_mimic.select_cohort(theirs.load_patients(), theirs.load_admissions(), theirs.load_icustays(),
                                   **kwargs)
    assert_table_equal(got, want, "cohort")
    if not kwargs:
        assert 91.4 in got["AGE"].tolist() and 3017 in got["ICUSTAY_ID"].tolist()


def test_mimic_postgres_source_equals_jax(mimic_dir):
    conn = sqlite3.connect(":memory:")
    conn.execute("ATTACH DATABASE ':memory:' AS mimiciii")
    for table in ("PATIENTS", "ADMISSIONS", "ICUSTAYS", "LABEVENTS", "D_LABITEMS"):
        df = jax_mimic.MIMICLoader(mimic_dir).load_table(table)
        df.columns = df.columns.str.lower()
        df.to_sql(table.lower(), conn, index=False)
        conn.execute(f"CREATE TABLE mimiciii.{table.lower()} AS SELECT * FROM main.{table.lower()}")
        conn.execute(f"DROP TABLE main.{table.lower()}")
    try:
        ours = mimic.MIMICLoader("/nonexistent", source="postgres", db_connection=conn)
        theirs = jax_mimic.MIMICLoader("/nonexistent", source="postgres", db_connection=conn)
        for table in ("PATIENTS", "ICUSTAYS", "D_LABITEMS"):
            assert_table_equal(ours.load_table(table), theirs.load_table(table), table)
        got = mimic.select_cohort(ours.load_patients(), ours.load_admissions(), ours.load_icustays())
        want = jax_mimic.select_cohort(theirs.load_patients(), theirs.load_admissions(), theirs.load_icustays())
        assert_table_equal(got, want, "cohort")
        labs = ours.load_labevents_for_cohort(got["SUBJECT_ID"], chunksize=50)
        jax_labs = theirs.load_labevents_for_cohort(want["SUBJECT_ID"], chunksize=50)
        jax_labs["CHARTTIME"] = pd.to_datetime(jax_labs["CHARTTIME"], errors="coerce")
        assert_table_equal(labs, jax_labs[list(labs)], "labevents")
    finally:
        conn.close()
    with pytest.raises(ValueError, match="sqlalchemy"):
        mimic.MIMICLoader("/nonexistent", source="postgres", db_connection="postgresql://u@h/mimic")


def test_filter_labs_for_cohort_equals_jax(mimic_dir):
    ours, theirs = mimic.MIMICLoader(mimic_dir), jax_mimic.MIMICLoader(mimic_dir)
    cohort = mimic.select_cohort(ours.load_patients(), ours.load_admissions(), ours.load_icustays())
    jcohort = jax_mimic.select_cohort(theirs.load_patients(), theirs.load_admissions(), theirs.load_icustays())
    full = theirs.load_labevents()
    for top_k, min_count in ((None, 1), (3, 1), (2, 6)):  # top 3 cuts a tie of patient counts
        labs, items = mimic.filter_labs_for_cohort(ours.load_labevents(), cohort, ours.load_d_labitems(),
                                                   top_k=top_k, min_patient_count=min_count)
        jlabs, jitems = jax_mimic.filter_labs_for_cohort(full, jcohort, theirs.load_d_labitems(), top_k=top_k,
                                                         min_patient_count=min_count)
        assert_table_equal(labs, jlabs[list(labs)].reset_index(drop=True), f"labs top {top_k}")
        assert_table_equal(items, jitems, f"labitems top {top_k}")


# -- eICU ----------------------------------------------------------------------------------


def test_parse_eicu_age_equals_jax():
    for values in (["45", "> 89", "bad", None, " 30 "], [45, 17], [45.0, np.nan], ["45", "90"]):
        got = eicu.parse_eicu_age(np.asarray(values, dtype=object if isinstance(values[0], str) else None))
        assert_column_equal("age", got, jax_eicu.parse_eicu_age(pd.Series(values)))


def test_eicu_views_equal_jax(eicu_dir):
    ours, theirs = eicu.EICULoader(eicu_dir), jax_eicu.EICULoader(eicu_dir)
    for view in ("load_labevents", "load_diagnoses_icd", "load_prescriptions", "load_d_labitems"):
        assert_table_equal(getattr(ours, view)(), getattr(theirs, view)(), view)
    cohort = eicu.select_cohort(ours.load_patients())
    jcohort = jax_eicu.select_cohort(theirs.load_patients())
    assert_table_equal(ours.load_apache_for_cohort(cohort), theirs.load_apache_for_cohort(jcohort), "apache")
    got, want = eicu.map_eicu_to_mimic_format(ours), jax_eicu.map_eicu_to_mimic_format(theirs)
    assert list(got) == list(want)
    for name in got:
        assert_table_equal(got[name], want[name], name)
    assert eicu.validate_eicu_data(ours) == jax_eicu.validate_eicu_data(theirs)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"use_first_icu_only": False}, {"exclude_deaths": True, "min_los_hours": 20.0},
     {"subject_limit": 3, "age_max": 60}, {"subject_limit": 50}],
)
def test_eicu_select_cohort_equals_jax(eicu_dir, kwargs):
    got = eicu.select_cohort(eicu.EICULoader(eicu_dir).load_patients(), **kwargs)
    want = jax_eicu.select_cohort(jax_eicu.EICULoader(eicu_dir).load_patients(), **kwargs)
    assert_table_equal(got, want, "cohort")


# -- preprocess transforms ---------------------------------------------------------------


@pytest.mark.parametrize("method", ["zscore", "minmax", "robust", "none"])
def test_lab_normalizer_equals_jax(method):
    rng = np.random.default_rng(1)
    groups = np.asarray([3, 1, 2, 1, 3, 3, 1, 5, 2, 2, 1, 4, 4, 4, 4], np.int64)  # 5: one value
    values = rng.normal(10, 3, len(groups))
    values[2] = np.nan
    values[11:] = 7.0  # a constant group: scale 0
    table = {"ITEMID": groups, "VALUE": values}
    jdf = pd.DataFrame(table)
    ours, theirs = norm.LabNormalizer(method), jax_norm.LabNormalizer(method)
    assert_column_equal("fit_transform", ours.fit_transform_frame(table, "VALUE", "ITEMID"),
                        theirs.fit_transform_frame(jdf, "VALUE", "ITEMID"))
    assert_table_equal(ours.to_frame(), theirs.to_frame(), "to_frame")
    back = norm.LabNormalizer.from_frame(ours.to_frame())
    jback = jax_norm.LabNormalizer.from_frame(theirs.to_frame())
    assert back.method == method and list(back.stats) == list(jback.stats)
    for lab, stats in jback.stats.items():
        assert back.stats[lab] == pytest.approx(stats, rel=REL)
    probe = np.asarray([1.0, 8.5, np.nan])
    for lab in (1, 4, 5, 99):
        assert_column_equal("inverse", ours.inverse_transform(probe, lab), theirs.inverse_transform(pd.Series(probe), lab))
        assert_column_equal("transform", ours.transform(probe, lab), theirs.transform(pd.Series(probe), lab))
    ours.fit(values[:5], "solo")
    theirs.fit(pd.Series(values[:5]), "solo")
    assert ours.stats["solo"] == pytest.approx(theirs.stats["solo"], rel=REL)


def test_outlier_removal_equals_jax():
    rng = np.random.default_rng(2)
    values = np.r_[rng.normal(0, 1, 60), [40.0, -35.0, np.nan]]
    groups = np.r_[np.repeat([7, 8], 30), [7, 8, 7]]
    for method in ("std", "iqr"):
        assert_column_equal(method, norm.remove_outliers(values, method, 3.0),
                            jax_norm.remove_outliers(pd.Series(values), method, 3.0))
    table = {"ITEMID": groups.astype(object), "VALUENUM": values}
    table["ITEMID"][5] = None  # a missing group keeps its row
    assert_column_equal("grouped", norm.remove_outliers_grouped(table, "VALUENUM", "ITEMID", 3.0),
                        jax_norm.remove_outliers_grouped(pd.DataFrame(table), "VALUENUM", "ITEMID", 3.0))


@pytest.mark.parametrize("method", ["last", "mean", "median", "min", "max"])
def test_aggregate_lab_values_equals_jax(mimic_dir, method):
    ours, theirs = mimic.MIMICLoader(mimic_dir), jax_mimic.MIMICLoader(mimic_dir)
    cohort = mimic.select_cohort(ours.load_patients(), ours.load_admissions(), ours.load_icustays())
    jcohort = jax_mimic.select_cohort(theirs.load_patients(), theirs.load_admissions(), theirs.load_icustays())
    got = pre.aggregate_lab_values(ours.load_labevents(), cohort, method=method)
    want = jax_pre.aggregate_lab_values(theirs.load_labevents(), jcohort, method=method)
    assert_table_equal(got, want.reset_index(drop=True), method)
    if method == "last":  # the NaT event and the tie's second row won
        pairs = dict(zip(zip(got["SUBJECT_ID"].tolist(), got["ITEMID"].tolist()), got["VALUE"].tolist()))
        assert pairs[(2, 50001)] == 77.0 and pairs[(1, 50001)] == 91.0 and (9, 50001) not in pairs


def test_drug_names_equal_jax():
    names = ["Aspirin 81 mg Tablet", "Heparin, Porcine 5000 units", "0.9% Sodium Chloride", None, "",
             "Metoprolol Tartrate 25mg Oral", "IV", "insulin (regular)", "Café-Crème 10 mcg solution", "  "]
    got = pre.normalize_drug_names(np.asarray(names, dtype=object))
    assert_column_equal("drugs", got, jax_pre.normalize_drug_names(pd.Series(names, dtype=object)))
    for name in names:
        assert pre.normalize_drug_name(name) == jax_pre.normalize_drug_name(name)


@pytest.mark.parametrize("numeric_icd", [False, True])
def test_diagnoses_and_medications_equal_jax(tmp_path, numeric_icd):
    raw = make_mimic_dir(tmp_path / "raw", numeric_icd=numeric_icd, seed=3)
    ours, theirs = mimic.MIMICLoader(raw), jax_mimic.MIMICLoader(raw)
    cohort = mimic.select_cohort(ours.load_patients(), ours.load_admissions(), ours.load_icustays())
    jcohort = jax_mimic.select_cohort(theirs.load_patients(), theirs.load_admissions(), theirs.load_icustays())
    for collapse, top_k, min_count in ((True, None, 1), (False, 3, 2)):
        got = pre.process_diagnoses(ours.load_diagnoses_icd(), cohort, collapse, top_k, min_count)
        want = jax_pre.process_diagnoses(theirs.load_diagnoses_icd(), jcohort, collapse, top_k, min_count)
        assert_table_equal(got, want, "diagnoses")
    if numeric_icd:  # read as ints: "0389" is 389, its first three characters "389"
        assert ours.load_diagnoses_icd()["ICD9_CODE"].dtype.kind == "i"
        assert "389" in pre.process_diagnoses(ours.load_diagnoses_icd(), cohort)["ICD3_CODE"].tolist()
    for normalize, top_k, min_count in ((True, None, 1), (False, 3, 2), (True, 2, 1)):
        got = pre.process_medications(ours.load_prescriptions(), cohort, normalize, top_k, min_count)
        want = jax_pre.process_medications(theirs.load_prescriptions(), jcohort, normalize, top_k, min_count)
        assert_table_equal(got, want, "medications")


def test_demographics_equal_jax(mimic_dir, eicu_dir):
    ours, theirs = mimic.MIMICLoader(mimic_dir), jax_mimic.MIMICLoader(mimic_dir)
    cohort = mimic.select_cohort(ours.load_patients(), ours.load_admissions(), ours.load_icustays())
    jcohort = jax_mimic.select_cohort(theirs.load_patients(), theirs.load_admissions(), theirs.load_icustays())
    assert_table_equal(pre.create_demographic_features(cohort, include_ethnicity=True),
                       jax_pre.create_demographic_features(jcohort, include_ethnicity=True), "mimic")
    one = frame.take(cohort, slice(0, 1))  # one patient: no spread, AGE_NORM 0
    assert_table_equal(pre.create_demographic_features(one), jax_pre.create_demographic_features(jcohort.head(1)),
                       "one")
    el, jel = eicu.EICULoader(eicu_dir), jax_eicu.EICULoader(eicu_dir)
    ec = eicu.select_cohort(el.load_patients())
    jec = jax_eicu.select_cohort(jel.load_patients())
    assert_table_equal(pre.create_demographic_features(ec, apache=el.load_apache_for_cohort(ec)),
                       jax_pre.create_demographic_features(jec, apache=jel.load_apache_for_cohort(jec)), "eicu")


# -- the stage and the graph ---------------------------------------------------------------


@pytest.mark.parametrize(
    "dataset,overrides",
    [
        ("mimic3", {}),
        ("mimic3", {"data": {"labevents_chunksize": 64}, "feature_space": {"labs": {"normalize": "robust"}}}),
        ("eicu", {}),
        ("eicu", {"feature_space": {"labs": {"aggregate": "mean", "outlier_std_threshold": None}},
                  "cohort": {"use_first_icu_only": False}}),
    ],
)
def test_preprocess_pipeline_and_graph_equal_jax(mimic_dir, eicu_dir, tmp_path, dataset, overrides):
    raw = mimic_dir if dataset == "mimic3" else eicu_dir
    cfg, _ = _configs(dataset, raw, tmp_path / "port", **overrides)
    _, jcfg2 = _configs(dataset, raw, tmp_path / "jax", **overrides)
    got = pre.preprocess_pipeline(cfg, interim_dir=cfg.data.interim_dir)
    want = jax_pre.preprocess_pipeline(jcfg2, interim_dir=jcfg2.data.interim_dir)
    assert list(got) == list(want)
    for name in want:
        assert_table_equal(got[name], want[name].reset_index(drop=True), name)
    for name, table in got.items():  # the interim files read back as written
        back = pre.load_table(Path(cfg.data.interim_dir) / f"{name}.npz")
        assert list(back) == list(table)
    # the slice as a whole: each package's graph from its own interim tables
    ours = build_graph_from_preprocessed(cfg.data.interim_dir, cfg)
    theirs = jax_build_graph(jcfg2.data.interim_dir, jcfg2)
    assert_graphs_equal(ours.graph, theirs.graph)
    assert ours.meta.lab_names == theirs.meta.lab_names
    for nt, ix in theirs.meta.indexers.items():
        assert ours.meta.indexers[nt].index_to_id == ix.index_to_id


# -- the ingest bench and the command line -------------------------------------------


def test_emitted_raw_mimic_equals_jax_script(tmp_path):
    """tools/bench_etl.emit_raw_mimic writes the tables scripts/bench_etl.py
    writes (same draws from one seed)."""
    import importlib.util

    from multi_modal_gnn_tpu_torch.tools import bench_etl

    spec = importlib.util.spec_from_file_location("jax_bench_etl", REPO / "scripts" / "bench_etl.py")
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    bench_etl.emit_raw_mimic(tmp_path / "port", 300, 6000, num_labs=40, num_dx=30, num_rx=20, seed=3)
    jax_bench.emit_raw_mimic(tmp_path / "jax", 300, 6000, num_labs=40, num_dx=30, num_rx=20, seed=3)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / name), pd.read_csv(tmp_path / "jax" / name))


def test_eicu_through_the_command_line(tmp_path):
    """``python -m multi_modal_gnn_tpu_torch`` on a raw eICU directory:
    steps 1-2 on the CPU write the interim tables and the graph."""
    from multi_modal_gnn_tpu_torch.config import save_config
    from multi_modal_gnn_tpu_torch.tools import bench_etl

    raw = bench_etl.emit_raw_eicu(tmp_path / "raw", num_stays=300, labs_per_stay=10)
    path = save_config(bench_etl.eicu_config(raw, tmp_path), tmp_path / "config.yaml")
    proc = subprocess.run(
        [sys.executable, "-m", "multi_modal_gnn_tpu_torch", "--config", str(path), "--step", "1-2", "--no-confirm",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["step_seconds"].keys() == {"preprocess", "build-graph"}
    assert sorted(p.name for p in (tmp_path / "interim").iterdir()) == sorted(
        f"{n}.npz" for n in ("cohort", "labs_normalized", "diagnoses", "medications", "demographics", "labitems",
                             "normalizer")
    )
    normalizer = pre.load_table(tmp_path / "interim" / "normalizer.npz")
    assert normalizer["lab_id"].dtype.kind == "U" and set(normalizer["method"].tolist()) == {"zscore"}
    assert (tmp_path / "out" / "graph.npz").exists()
