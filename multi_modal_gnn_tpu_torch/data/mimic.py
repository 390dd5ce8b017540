"""MIMIC-III loader, cohort selection and top-K lab filtering
(``multi_modal_gnn_tpu/data/mimic.py``) on numpy tables.

Tables are read from ``<NAME>.csv`` or ``.csv.gz`` in upper, lower or
as-written case, headers upper-cased (:func:`utils.csv_table.read_csv`),
or with ``source="postgres"`` from ``mimiciii.<name>`` through a DBAPI
connection object's cursor.  LABEVENTS goes through the graph core's
one-pass scan (:func:`native.labevents_scan`); the chunked Python scan
(:meth:`MIMICLoader.load_labevents` with ``chunksize``) is its plain
version.
"""

from __future__ import annotations

import csv
import io
import itertools
import logging
from pathlib import Path
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from multi_modal_gnn_tpu_torch import native
from multi_modal_gnn_tpu_torch.utils import frame
from multi_modal_gnn_tpu_torch.utils.csv_table import parse_column, read_csv, to_datetime
from multi_modal_gnn_tpu_torch.utils.frame import Table

logger = logging.getLogger(__name__)

LAB_COLUMNS = ("SUBJECT_ID", "ITEMID", "VALUENUM")


def _empty_labs() -> Table:
    return {name: np.zeros(0, np.int64 if name != "VALUENUM" else np.float64) for name in LAB_COLUMNS}


class MIMICLoader:
    """Loads MIMIC-III tables from CSV files or a database connection."""

    def __init__(self, data_dir: Union[str, Path], source: str = "csv", db_connection=None):
        self.data_dir = Path(data_dir)
        self.source = source
        self.db_connection = db_connection
        if source == "csv" and not self.data_dir.exists():
            raise FileNotFoundError(f"Data directory not found: {self.data_dir}")
        if source == "postgres" and db_connection is None:
            raise ValueError("db_connection required for postgres source")
        if source == "postgres" and isinstance(db_connection, str):
            raise ValueError(
                "db_connection as a URL string needs sqlalchemy, which this package does not use: "
                "pass an open DBAPI connection (psycopg2.connect(...), sqlite3.connect(...))"
            )

    def _csv_path(self, table_name: str) -> Path:
        for candidate in (table_name, table_name.lower(), table_name.upper()):
            for suffix in (".csv", ".csv.gz"):
                path = self.data_dir / f"{candidate}{suffix}"
                if path.exists():
                    return path
        raise FileNotFoundError(f"CSV file not found for table: {table_name}")

    def _load_postgres(self, table_name: str, chunksize: Optional[int] = None) -> Iterator[Table]:
        """``SELECT * FROM mimiciii.<table>`` through the connection's
        cursor, as tables of at most ``chunksize`` rows (one table without)."""
        cur = self.db_connection.cursor()
        try:
            cur.execute(f"SELECT * FROM mimiciii.{table_name.lower()}")
            names = [d[0].upper() for d in cur.description]
            if not chunksize:
                yield _rows_table(names, cur.fetchall())
                return
            while True:
                rows = cur.fetchmany(chunksize)
                if not rows:
                    return
                yield _rows_table(names, rows)
        finally:
            cur.close()

    def load_table(self, table_name: str) -> Table:
        if self.source == "csv":
            table = read_csv(self._csv_path(table_name), upper=True)
        else:
            table = next(self._load_postgres(table_name))
        logger.info("Loaded %s: %d rows", table_name, frame.nrows(table))
        return table

    def load_patients(self) -> Table:
        return self.load_table("PATIENTS")

    def load_admissions(self) -> Table:
        return self.load_table("ADMISSIONS")

    def load_icustays(self) -> Table:
        return self.load_table("ICUSTAYS")

    def load_labevents(self, chunksize: Optional[int] = None):
        """Without ``chunksize``: SUBJECT_ID, ITEMID, VALUENUM and CHARTTIME
        (``datetime64``) of every row with a numeric VALUENUM, by the graph
        core's scan of the CSV (other columns and rows without a value are
        not read; a database source reads the whole table).  With it: an
        iterator of whole tables of at most ``chunksize`` rows."""
        if chunksize:
            if self.source == "csv":
                return _csv_chunks(self._csv_path("LABEVENTS"), chunksize)
            return self._load_postgres("LABEVENTS", chunksize)
        if self.source == "csv":
            return self._scan(None)
        table = self.load_table("LABEVENTS")
        if "CHARTTIME" in table:
            table["CHARTTIME"] = to_datetime(table["CHARTTIME"])
        return table

    def load_labevents_for_cohort(self, cohort_subject_ids, chunksize: int = 1_000_000) -> Table:
        """The numeric LABEVENTS rows of the cohort's patients: the graph
        core's scan of a CSV source, the chunked scan of a database's."""
        ids = np.unique(np.asarray(cohort_subject_ids, np.int64))
        if not len(ids):
            # the scan reads an empty id set as "keep every row"; an empty
            # cohort keeps none
            return _empty_labs()
        if self.source == "csv":
            return self._scan(ids)
        return self.load_labevents_for_cohort_plain(ids, chunksize)

    def load_labevents_for_cohort_plain(self, cohort_subject_ids, chunksize: int = 1_000_000) -> Table:
        """:meth:`load_labevents_for_cohort` by the chunked scan, the scan's
        plain version: each chunk read whole and filtered to cohort patients
        with a VALUENUM; the scan's columns, CHARTTIME parsed."""
        ids = np.unique(np.asarray(cohort_subject_ids, np.int64))
        kept, total = [], 0
        for chunk in self.load_labevents(chunksize=chunksize):
            total += frame.nrows(chunk)
            sel = frame.isin(chunk["SUBJECT_ID"], ids) & ~frame.isna(chunk["VALUENUM"])
            if sel.any():
                names = [c for c in (*LAB_COLUMNS, "CHARTTIME") if c in chunk]
                part = frame.select(frame.take(chunk, sel), names)
                if "CHARTTIME" in part:
                    part["CHARTTIME"] = to_datetime(part["CHARTTIME"].astype(object))
                kept.append(part)
        if not kept:
            return _empty_labs()
        out = {name: np.concatenate([k[name] for k in kept]) for name in kept[0]}
        logger.info("Chunked LABEVENTS ingest: kept %d/%d rows for %d cohort patients",
                    frame.nrows(out), total, len(ids))
        return out

    def _scan(self, ids: Optional[np.ndarray]) -> Table:
        """The graph core's scan (every patient when ``ids`` is None)."""
        path = self._csv_path("LABEVENTS")
        header = [c.strip().strip('"').upper() for c in _first_line(path).strip().split(",")]
        try:
            cols = [header.index(c) for c in LAB_COLUMNS]
        except ValueError:
            raise ValueError(f"{path.name}: a LABEVENTS table needs {LAB_COLUMNS}, has {header}") from None
        col_time = header.index("CHARTTIME") if "CHARTTIME" in header else -1
        keep = np.zeros(0, np.int64) if ids is None else ids
        subj, item, val, time_s = native.labevents_scan(path, *cols, col_time, keep)
        out = {"SUBJECT_ID": subj.astype(np.int64), "ITEMID": item.astype(np.int64), "VALUENUM": val}
        if col_time >= 0:
            charttime = time_s.astype("datetime64[s]").astype("datetime64[us]")
            charttime[time_s < 0] = np.datetime64("NaT")
            out["CHARTTIME"] = charttime
        logger.info("Native LABEVENTS scan: kept %d rows (%s)", len(subj), path.name)
        return out

    def load_d_labitems(self) -> Table:
        return self.load_table("D_LABITEMS")

    def load_diagnoses_icd(self) -> Table:
        return self.load_table("DIAGNOSES_ICD")

    def load_prescriptions(self) -> Table:
        return self.load_table("PRESCRIPTIONS")


def _first_line(path: Path) -> str:
    with native.open_bytes(path) as f:
        return f.readline().decode("latin-1")


def _csv_chunks(path: Path, chunksize: int) -> Iterator[Table]:
    """A CSV in tables of at most ``chunksize`` rows, headers upper-cased
    (each column's type inferred per chunk, as pandas' chunked reader
    infers it)."""
    with native.open_bytes(path) as raw:
        reader = csv.reader(io.TextIOWrapper(raw, newline=""))
        names = [h.upper() for h in next(reader)]
        rows_iter = (r for r in reader if r)
        while True:
            rows = list(itertools.islice(rows_iter, chunksize))
            if not rows:
                return
            cols = list(itertools.zip_longest(*rows, fillvalue=""))
            yield {n: parse_column(list(c)) for n, c in zip(names, cols)}


def _rows_table(names, rows) -> Table:
    """Database rows as a table: each column's values as ``read_sql`` types
    them (ints, floats, strings; ``None`` where missing)."""
    cols = list(zip(*rows)) if rows else [() for _ in names]
    return {name: _db_column(list(col)) for name, col in zip(names, cols)}


def _db_column(values: list) -> np.ndarray:
    present = [v for v in values if v is not None]
    if present and all(isinstance(v, (bool, np.bool_)) for v in present) and len(present) == len(values):
        return np.asarray(values, bool)
    if present and all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in present):
        if len(present) == len(values):
            return np.asarray(values, np.int64)
        return np.asarray([np.nan if v is None else v for v in values], np.float64)
    if present and all(isinstance(v, (int, float, np.integer, np.floating)) for v in present):
        return np.asarray([np.nan if v is None else v for v in values], np.float64)
    if not present:
        return np.full(len(values), np.nan) if values else np.zeros(0)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def select_cohort(
    patients: Table,
    admissions: Table,
    icustays: Table,
    age_min: int = 18,
    age_max: Optional[int] = None,
    use_first_icu_only: bool = True,
    subject_limit: Optional[int] = None,
    min_los_hours: Optional[float] = None,
    exclude_deaths: bool = False,
    **_unused,
) -> Table:
    """MIMIC-III cohort selection (JAX ``data/mimic.py:select_cohort``): ICU
    stays inner-merged with admissions on (SUBJECT_ID, HADM_ID), then with
    patients on SUBJECT_ID (rows in the stays' order); age in whole years
    from the dates (over 89 becomes 91.4); the filters; the first stay per
    patient by (SUBJECT_ID, INTIME) with INTIME sorted as written."""
    adm_cols = ("SUBJECT_ID", "HADM_ID", "ADMITTIME", "ETHNICITY", "HOSPITAL_EXPIRE_FLAG")
    cohort = frame.merge(icustays, frame.select(admissions, adm_cols), on=["SUBJECT_ID", "HADM_ID"])
    cohort = frame.merge(cohort, frame.select(patients, ("SUBJECT_ID", "GENDER", "DOB")), on=["SUBJECT_ID"])
    logger.info("After merge: %d ICU stays", frame.nrows(cohort))

    admit = to_datetime(cohort["ADMITTIME"])
    dob = to_datetime(cohort["DOB"])
    a_y, a_m, a_d = _ymd(admit)
    d_y, d_m, d_d = _ymd(dob)
    # year arithmetic (no datetime overflow on obfuscated DOBs); a missing
    # date makes the age NaN and fails every comparison
    not_yet = (a_m < d_m) | ((a_m == d_m) & (a_d < d_d))
    age = a_y - d_y - not_yet.astype(np.float64)
    # > 89 is date-obfuscated in MIMIC: the conventional 91.4
    cohort["AGE"] = np.where(age > 89, 91.4, age)

    keep = cohort["AGE"] >= age_min
    if age_max is not None:
        keep &= cohort["AGE"] <= age_max
    cohort = frame.take(cohort, keep)
    logger.info("After age filter: %d", frame.nrows(cohort))

    if min_los_hours is not None:
        cohort = frame.take(cohort, np.asarray(cohort["LOS"], np.float64) >= min_los_hours / 24.0)
        logger.info("After LOS filter: %d", frame.nrows(cohort))

    if exclude_deaths:
        flag = np.asarray(cohort["HOSPITAL_EXPIRE_FLAG"])
        cohort = frame.take(cohort, flag == 0)
        logger.info("After excluding deaths: %d", frame.nrows(cohort))

    if use_first_icu_only:
        # whole-row dedup: the first stay's every field
        cohort = frame.take(cohort, frame.sort_order(cohort, ["SUBJECT_ID", "INTIME"]))
        cohort = frame.take(cohort, frame.drop_duplicates(cohort, ["SUBJECT_ID"]))
        logger.info("After first ICU stay only: %d", frame.nrows(cohort))

    if subject_limit is not None:
        cohort = frame.take(cohort, slice(0, subject_limit))

    cols = [c for c in ("SUBJECT_ID", "HADM_ID", "ICUSTAY_ID", "AGE", "GENDER", "ETHNICITY",
                        "INTIME", "OUTTIME", "LOS") if c in cohort]
    cohort = frame.select(cohort, cols)
    logger.info("Final MIMIC cohort: %d", frame.nrows(cohort))
    return cohort


def _ymd(dates: np.ndarray):
    """Year, month, day of ``datetime64`` values as float64 (NaN at NaT)."""
    nat = np.isnat(dates)
    safe = np.where(nat, np.datetime64(0, "us"), dates)
    y = safe.astype("datetime64[Y]").astype(np.int64) + 1970
    m = safe.astype("datetime64[M]").astype(np.int64) % 12 + 1
    d = (safe.astype("datetime64[D]") - safe.astype("datetime64[M]").astype("datetime64[D]")).astype(np.int64) + 1
    out = []
    for part in (y, m, d):
        part = part.astype(np.float64)
        part[nat] = np.nan
        out.append(part)
    return out


def filter_labs_for_cohort(
    labevents: Table,
    cohort: Table,
    d_labitems: Table,
    top_k: Optional[int] = None,
    min_patient_count: int = 10,
) -> Tuple[Table, Table]:
    """The numeric labs of cohort patients for the top-K most widely
    ordered tests (JAX ``filter_labs_for_cohort``): per ITEMID the distinct
    patients and the measurements; tests with at least
    ``min_patient_count`` patients; ``nlargest(top_k)`` by patients (ties
    in ITEMID order).  Returns the labs (in table order) and the dictionary
    rows of the selected tests with NUM_PATIENTS / NUM_MEASUREMENTS."""
    labs = frame.take(labevents, frame.isin(labevents["SUBJECT_ID"], cohort["SUBJECT_ID"]))
    labs = frame.take(labs, ~frame.isna(labs["VALUENUM"]))
    logger.info("Numeric cohort labs: %d events", frame.nrows(labs))

    g = frame.GroupBy(labs, ["ITEMID"])
    items = g.key_values["ITEMID"]
    num_patients = g.nunique(labs["SUBJECT_ID"])
    num_meas = g.count(labs["VALUENUM"])
    ok = num_patients >= min_patient_count
    items, num_patients, num_meas = items[ok], num_patients[ok], num_meas[ok]
    if top_k is not None:
        order = np.argsort(-num_patients, kind="stable")[:top_k]
        items, num_patients, num_meas = items[order], num_patients[order], num_meas[order]
    logger.info("Selected %d lab tests", len(items))

    labs = frame.take(labs, frame.isin(labs["ITEMID"], items))
    labitems = frame.take(d_labitems, frame.isin(d_labitems["ITEMID"], items))
    counts = {"ITEMID": items, "NUM_PATIENTS": num_patients.astype(np.int64),
              "NUM_MEASUREMENTS": num_meas.astype(np.int64)}
    labitems = frame.merge(labitems, counts, on=["ITEMID"])
    return labs, labitems
