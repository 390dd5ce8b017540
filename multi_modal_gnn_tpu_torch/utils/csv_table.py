"""CSV tables as dicts of numpy columns, read as ``pandas.read_csv`` reads
the raw eICU and MIMIC-III exports (the JAX package's loaders), and the
date parser of ``pandas.to_datetime(..., errors="coerce")``.

A :data:`Table` maps column names, in file order, to equal-length numpy
arrays.  Each column's type is inferred as ``read_csv`` infers it:

* the NA strings of :data:`NA_VALUES` (``""``, ``NA``, ``NaN``, ``null``,
  ``N/A`` ...) are missing, quoted or not; lines with no characters are
  skipped;
* a column whose present values are all integers is ``int64``, or
  ``float64`` when a value is missing (``" 30 "`` and ``"+5"`` are
  integers; ``"1_000"`` is not), or ``object`` Python ints past int64;
* else all numbers (decimal, exponent, ``inf`` / ``infinity``):
  ``float64``;
* else all of ``True`` / ``False`` (three spellings each) with none
  missing: ``bool``;
* else ``object``: Python strings, ``None`` where missing.  A column with
  no value at all is ``float64`` NaN.

Datetime columns are ``datetime64[us]`` with NaT where missing.
"""

from __future__ import annotations

import csv
import datetime as dt
import gzip
import itertools
import re
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

Table = Dict[str, np.ndarray]

# pandas' default NA strings (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
_TRUE = frozenset(["True", "TRUE", "true"])
_FALSE = frozenset(["False", "FALSE", "false"])
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)\s*", re.IGNORECASE)

NAT = np.datetime64("NaT", "us")


def _open_text(path: Path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt", newline="")
    return open(path, newline="")


def read_csv(path, upper: bool = False) -> Table:
    """A CSV or gzip CSV file (told apart by its magic bytes) as a
    :data:`Table`; ``upper`` upper-cases the header, as the MIMIC-III loader
    does.  Fields may be quoted (commas inside), ``""`` escapes a quote.
    Rows with fewer fields than the header are filled with missing values;
    a row with more raises."""
    with _open_text(Path(path)) as f:
        return read_csv_text(f, upper=upper)


def read_csv_text(f, upper: bool = False) -> Table:
    """:func:`read_csv` on an open text stream."""
    reader = csv.reader(f)
    header = next(reader, None)
    if header is None:
        return {}
    names = [h.upper() if upper else h for h in header]
    rows = [r for r in reader if r]  # a line with no characters is skipped
    for i, r in enumerate(rows):
        if len(r) > len(names):
            raise ValueError(f"line {i + 2}: {len(r)} fields, the header has {len(names)}")
    columns = itertools.zip_longest(*rows, fillvalue="") if rows else [[] for _ in names]
    cols = list(columns)
    if len(cols) < len(names):  # every row shorter than the header
        cols += [[""] * len(rows)] * (len(names) - len(cols))
    return {name: parse_column(list(col)) for name, col in zip(names, cols)}


def parse_column(values: Sequence[str]) -> np.ndarray:
    """Raw CSV fields as a typed column (module docstring)."""
    uniq = dict.fromkeys(values)
    present = [u for u in uniq if u not in NA_VALUES]
    missing = len(present) < len(uniq)
    if not present:
        return np.full(len(values), np.nan)
    if all(_INT.fullmatch(u) for u in present):
        try:
            if not missing:
                return np.asarray(values).astype(np.int64)
            as_int = {u: int(u) for u in present}
            arr = np.fromiter((as_int.get(v, 0) for v in values), np.int64, len(values)).astype(np.float64)
            arr[_na_mask(values)] = np.nan
            return arr
        except OverflowError:  # past int64: Python ints, as pandas keeps them
            out = np.empty(len(values), dtype=object)
            out[:] = [None if v in NA_VALUES else int(v) for v in values]
            return out
    if all(_FLOAT.fullmatch(u) for u in present):
        if not missing:
            return np.asarray(values).astype(np.float64)
        as_float = {u: float(u.strip()) for u in present}
        return np.fromiter((as_float.get(v, np.nan) for v in values), np.float64, len(values))
    if not missing and all(u in _TRUE or u in _FALSE for u in present):
        return np.fromiter((v in _TRUE for v in values), bool, len(values))
    out = np.empty(len(values), dtype=object)
    out[:] = [None if v in NA_VALUES else v for v in values]
    return out


def _na_mask(values: Sequence[str]) -> np.ndarray:
    return np.fromiter((v in NA_VALUES for v in values), bool, len(values))


# -- dates ----------------------------------------------------------------------

_D = r"(\d{4})-(\d{1,2})-(\d{1,2})"
_T = r"(\d{1,2}):(\d{1,2})"
# the formats to_datetime guesses for these exports, most specific first
_FORMATS = [
    ("%Y-%m-%d %H:%M:%S.%f", re.compile(_D + " " + _T + r":(\d{1,2})\.(\d{1,6})")),
    ("%Y-%m-%d %H:%M:%S", re.compile(_D + " " + _T + r":(\d{1,2})")),
    ("%Y-%m-%dT%H:%M:%S.%f", re.compile(_D + "T" + _T + r":(\d{1,2})\.(\d{1,6})")),
    ("%Y-%m-%dT%H:%M:%S", re.compile(_D + "T" + _T + r":(\d{1,2})")),
    ("%Y-%m-%d %H:%M", re.compile(_D + " " + _T)),
    ("%Y-%m-%dT%H:%M", re.compile(_D + "T" + _T)),
    ("%Y-%m-%d", re.compile(_D)),
    ("%m/%d/%Y %H:%M:%S", re.compile(r"(\d{1,2})/(\d{1,2})/(\d{4}) " + _T + r":(\d{1,2})")),
    ("%m/%d/%Y", re.compile(r"(\d{1,2})/(\d{1,2})/(\d{4})")),
]


def _from_groups(fmt: str, g) -> Optional[np.datetime64]:
    nums = [int(x) for x in g]
    if fmt.startswith("%m/%d/%Y"):
        nums[0], nums[1], nums[2] = nums[2], nums[0], nums[1]
    if fmt.endswith("%f"):
        nums[-1] = int(g[-1].ljust(6, "0"))
    try:
        return np.datetime64(dt.datetime(*nums), "us")
    except ValueError:
        return None


def _parse_with(fmt: str, value: str) -> np.datetime64:
    pattern = dict(_FORMATS)[fmt]
    m = pattern.fullmatch(value)
    got = _from_groups(fmt, m.groups()) if m else None
    return NAT if got is None else got


def guess_datetime_format(value: str) -> Optional[str]:
    """The format of one value, among those :func:`to_datetime` knows."""
    for fmt, pattern in _FORMATS:
        if pattern.fullmatch(value):
            return fmt
    return None


def to_datetime(col, fmt: Optional[str] = None) -> np.ndarray:
    """``pandas.to_datetime(col, format=fmt, errors="coerce")`` of a string
    column as ``datetime64[us]``.  Without ``fmt`` the format is guessed from
    the first present value and every value must match it (a value of
    another shape, or an impossible date, is NaT); where the first value
    matches no known format, each value is parsed on its own.  An explicit
    ``fmt`` is parsed by ``datetime.strptime`` (a time alone falls on
    1900-01-01)."""
    arr = np.asarray(col, dtype=object) if not isinstance(col, np.ndarray) else col
    if np.issubdtype(arr.dtype, np.datetime64):
        return arr.astype("datetime64[us]")
    if arr.dtype != object:
        raise TypeError(f"to_datetime takes strings or datetimes, got {arr.dtype}")
    strings = [v if isinstance(v, str) and v not in NA_VALUES else None for v in arr.tolist()]
    uniq = [u for u in dict.fromkeys(strings) if u is not None]
    if fmt is not None:
        parsed = {u: _strptime(u, fmt) for u in uniq}
    else:
        first = next((s for s in strings if s is not None), None)
        guess = guess_datetime_format(first) if first is not None else None
        if guess is not None:
            parsed = {u: _parse_with(guess, u) for u in uniq}
        else:
            parsed = {u: _parse_any(u) for u in uniq}
    out = np.empty(len(strings), dtype="datetime64[us]")
    out[:] = [NAT if s is None else parsed[s] for s in strings]
    return out


def _strptime(value: str, fmt: str) -> np.datetime64:
    try:
        return np.datetime64(dt.datetime.strptime(value, fmt), "us")
    except ValueError:
        return NAT


def _parse_any(value: str) -> np.datetime64:
    fmt = guess_datetime_format(value.strip())
    return NAT if fmt is None else _parse_with(fmt, value.strip())


def to_numeric(col) -> np.ndarray:
    """``pandas.to_numeric(col, errors="coerce")``: numbers as they are,
    strings that read as numbers as float64 (int64 where every value is an
    integer and none is missing), anything else NaN."""
    arr = np.asarray(col)
    if arr.dtype != object and arr.dtype.kind in "biuf":
        return arr
    values = ["" if v is None or (isinstance(v, float) and v != v) else str(v) for v in arr.tolist()]
    uniq = dict.fromkeys(values)
    if all(u not in NA_VALUES and _INT.fullmatch(u) for u in uniq) and uniq:
        return np.fromiter((int(v) for v in values), np.int64, len(values))
    num = {u: float(u.strip()) if u not in NA_VALUES and _FLOAT.fullmatch(u) else np.nan for u in uniq}
    return np.fromiter((num[v] for v in values), np.float64, len(values))
