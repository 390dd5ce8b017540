"""Row operations on :data:`~multi_modal_gnn_tpu_torch.utils.csv_table.Table`
columns with the semantics of the pandas calls the JAX package's loaders
and preprocess make: missing values (NaN, NaT, ``None``), stable sorts
with missing values last, first-seen factorization, ``isin`` and merges
that match a missing key with a missing key, groupby's sorted groups that
drop missing keys, and ``value_counts`` with ties in first-seen order.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

Table = Dict[str, np.ndarray]


def nrows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def isna(col: np.ndarray) -> np.ndarray:
    """Missing values: NaN, NaT, ``None`` (and NaN in an object column)."""
    col = np.asarray(col)
    if col.dtype == object:
        values = col.tolist()
        if set(map(type, values)) <= {str}:
            return np.zeros(len(values), bool)
        return np.fromiter((v is None or (isinstance(v, float) and v != v) for v in values), bool, len(values))
    if col.dtype.kind in "fmM":
        return np.isnan(col)
    return np.zeros(len(col), bool)


def objects(values) -> np.ndarray:
    """``values`` as a 1-D object column (strings stay Python strings)."""
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def as_str(col: np.ndarray) -> np.ndarray:
    """``astype(str)`` / ``astype("string")`` as pandas 3 makes them: each
    value's text (a float as Python writes it, ``250.0``), missing values
    kept missing (``None``)."""
    col = np.asarray(col)
    if col.dtype.kind in "iub":
        return col.astype(str).astype(object)
    values = col.tolist()
    if set(map(type, values)) <= {str}:
        return objects(values)
    miss = isna(col)
    return objects([None if m else (v if isinstance(v, str) else str(v)) for v, m in zip(values, miss)])


def take(table: Table, rows) -> Table:
    """The rows ``rows`` (indices or a boolean mask) of every column."""
    return {name: col[rows] for name, col in table.items()}


def select(table: Table, names: Sequence[str]) -> Table:
    return {name: table[name] for name in names}


def _codes(cols: Sequence[np.ndarray]) -> Tuple[np.ndarray, int]:
    """One integer code per value of the concatenated ``cols``, equal codes
    for equal values (every missing value one code), and the code count.
    Codes of numbers follow their order; codes of strings first-seen order."""
    arrays = [np.asarray(c) for c in cols]
    if all(a.dtype != object for a in arrays):
        joined = np.concatenate(arrays) if len(arrays) > 1 else arrays[0]
        miss = isna(joined)
        codes = np.full(len(joined), -1, np.int64)
        uniq, inv = np.unique(joined[~miss], return_inverse=True)
        codes[~miss] = inv.ravel()
        n = len(uniq)
        if miss.any():
            codes[miss] = n
            n += 1
        return codes, n
    values = [v for a in arrays for v in a.tolist()]
    if set(map(type, values)) <= {str, type(None)}:  # strings: None is the one missing key
        keyed = values
    else:
        missing = object()
        keyed = [missing if v is None or (isinstance(v, float) and v != v) else _hashable(v) for v in values]
    seen = {k: i for i, k in enumerate(dict.fromkeys(keyed))}  # first-seen order
    return np.fromiter(map(seen.__getitem__, keyed), np.int64, len(values)), len(seen)


def _hashable(v):
    # 1 and 1.0 are one key, as pandas hashes them
    if isinstance(v, (np.integer, np.floating)):
        v = v.item()
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v


def row_codes(table: Table, names: Sequence[str], other: Optional[Table] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Codes of the key tuples of ``table[names]`` (and of ``other[names]``
    in the same code space): equal tuples, equal codes."""
    n_left = nrows(table)
    combined = np.zeros(n_left + (nrows(other) if other is not None else 0), np.int64)
    for name in names:
        cols = [table[name]] + ([other[name]] if other is not None else [])
        codes, n = _codes(cols)
        combined = combined * n + codes
        _, combined = np.unique(combined, return_inverse=True)
        combined = combined.ravel().astype(np.int64)
    return combined[:n_left], combined[n_left:]


def isin(col: np.ndarray, values: np.ndarray) -> np.ndarray:
    """``Series.isin``: a missing value matches a missing value."""
    col, values = np.asarray(col), np.asarray(values)
    if col.dtype != object and values.dtype != object and col.dtype.kind == values.dtype.kind:
        out = np.isin(col, values)
        if col.dtype.kind in "fmM" and isna(values).any():
            out |= isna(col)
        return out
    left, right = row_codes({"k": col}, ["k"], {"k": values})
    return np.isin(left, right)


def sort_rank(col: np.ndarray) -> np.ndarray:
    """Ascending ranks of a column's values (equal values, equal ranks),
    missing values after every present one."""
    col = np.asarray(col)
    miss = isna(col)
    rank = np.zeros(len(col), np.int64)
    present = col[~miss]
    if col.dtype == object:
        uniq = sorted(set(present.tolist()))
        pos = {u: i for i, u in enumerate(uniq)}
        rank[~miss] = np.fromiter((pos[v] for v in present.tolist()), np.int64, len(present))
        n = len(uniq)
    else:
        uniq, inv = np.unique(present, return_inverse=True)
        rank[~miss] = inv.ravel()
        n = len(uniq)
    rank[miss] = n
    return rank


def _sort_key(col: np.ndarray) -> np.ndarray:
    """A key ``np.lexsort`` orders as pandas sorts the column: numbers and
    datetimes as they are (NaN and NaT sort last), others by rank."""
    col = np.asarray(col)
    return col if col.dtype.kind in "biufmM" else sort_rank(col)


def sort_order(table: Table, by: Sequence[str]) -> np.ndarray:
    """``sort_values(by)``: a stable order, missing values last per key."""
    keys = [_sort_key(table[name]) for name in reversed(list(by))]
    return np.lexsort(keys) if keys else np.arange(nrows(table))


def drop_duplicates(table: Table, subset: Sequence[str]) -> np.ndarray:
    """Rows kept by ``drop_duplicates(subset, keep="first")``, in order."""
    codes, _ = row_codes(table, subset)
    _, first = np.unique(codes, return_index=True)
    return np.sort(first)


def merge(left: Table, right: Table, on: Sequence[str], how: str = "inner") -> Table:
    """``left.merge(right, on=on, how=how)`` for ``inner`` and ``left``:
    rows in left order, each left row's matches in right order; ``left``
    keeps unmatched rows with missing right values (ints become float).
    Columns: left's, then right's others."""
    if how not in ("inner", "left"):
        raise ValueError(f"merge how={how!r}: only inner and left")
    lk, rk = row_codes(left, on, right)
    r_order = np.argsort(rk, kind="stable")
    r_sorted = rk[r_order]
    lo = np.searchsorted(r_sorted, lk, "left")
    hi = np.searchsorted(r_sorted, lk, "right")
    counts = hi - lo
    if how == "left":
        counts_out = np.maximum(counts, 1)
    else:
        counts_out = counts
    left_rows = np.repeat(np.arange(len(lk)), counts_out)
    offsets = np.arange(len(left_rows)) - np.repeat(np.cumsum(counts_out) - counts_out, counts_out)
    matched = np.repeat(counts > 0, counts_out)
    right_pos = np.repeat(lo, counts_out) + offsets
    right_rows = np.where(matched, r_order[np.minimum(right_pos, len(r_order) - 1)] if len(r_order) else 0, -1)
    out = {name: col[left_rows] for name, col in left.items()}
    for name, col in right.items():
        if name in on:
            continue
        out[name] = _take_or_missing(col, right_rows)
    return out


def _take_or_missing(col: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``col[rows]`` with a missing value where ``rows`` is -1 (an int or
    bool column becomes float / object, as pandas' reindexing makes it)."""
    miss = rows < 0
    if not miss.any():
        return col[rows]
    safe = np.where(miss, 0, rows)
    if col.dtype.kind in "iu":
        out = col[safe].astype(np.float64) if len(col) else np.zeros(len(rows))
        out[miss] = np.nan
    elif col.dtype.kind == "f":
        out = col[safe] if len(col) else np.zeros(len(rows))
        out[miss] = np.nan
    elif col.dtype.kind == "M":
        out = col[safe] if len(col) else np.zeros(len(rows), col.dtype)
        out[miss] = np.datetime64("NaT")
    else:
        out = col[safe].astype(object) if len(col) else np.empty(len(rows), object)
        out[miss] = None
    return out


class GroupBy:
    """``groupby(keys)`` (``sort=True``, ``dropna=True``): groups in the
    sorted order of their keys; rows with a missing key belong to none
    (``codes == -1``)."""

    def __init__(self, table: Table, keys: Sequence[str]):
        self.keys = list(keys)
        miss = np.zeros(nrows(table), bool)
        for k in self.keys:
            miss |= isna(table[k])
        self.valid = ~miss
        rows = np.nonzero(self.valid)[0]
        cols = [np.asarray(table[k])[rows] for k in self.keys]
        order = np.lexsort([_sort_key(c) for c in reversed(cols)]) if cols else np.arange(len(rows))
        change = np.zeros(len(rows), bool)
        if len(rows):
            change[0] = True
            for c in cols:
                c = c[order]
                change[1:] |= c[1:] != c[:-1]
        gid = np.cumsum(change) - 1
        self.codes = np.full(nrows(table), -1, np.int64)
        self.codes[rows[order]] = gid
        self.ngroups = int(change.sum())
        self.first_row = rows[order[change]]  # each group's first row, groups in key order
        self.key_values = {k: table[k][self.first_row] for k in self.keys}

    def count(self, col: np.ndarray) -> np.ndarray:
        """Present values per group."""
        ok = self.valid & ~isna(col)
        return np.bincount(self.codes[ok], minlength=self.ngroups)

    def nunique(self, col: np.ndarray) -> np.ndarray:
        """Distinct present values per group."""
        ok = self.valid & ~isna(col)
        vals, _ = _codes([np.asarray(col)[ok]])
        pairs = np.unique(self.codes[ok] * (int(vals.max()) + 1 if len(vals) else 1) + vals)
        return np.bincount(pairs // (int(vals.max()) + 1 if len(vals) else 1), minlength=self.ngroups)

    def sorted_values(self, col: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(values, group, starts)``: the present values of ``col`` (as
        float64) sorted by group and, within a group, ascending; each
        value's group; each group's start (``ngroups + 1`` entries)."""
        v = np.asarray(col, np.float64)
        ok = self.valid & ~np.isnan(v)
        g = self.codes[ok]
        order = np.lexsort((v[ok], g))
        g = g[order]
        return v[ok][order], g, np.searchsorted(g, np.arange(self.ngroups + 1))

    def reduce(self, col: np.ndarray, how: str) -> np.ndarray:
        """One float64 per group (NaN for a group with no present value):
        ``mean``, ``std`` (ddof 1; NaN for one value), ``min``, ``max``,
        ``median``; missing values skipped, as pandas' reductions skip them."""
        out = np.full(self.ngroups, np.nan)
        if how in ("mean", "std"):  # no sort needed
            v = np.asarray(col, np.float64)
            ok = self.valid & ~np.isnan(v)
            g, v = self.codes[ok], v[ok]
            n = np.bincount(g, minlength=self.ngroups)
            mean = np.bincount(g, weights=v, minlength=self.ngroups) / np.maximum(n, 1)
            if how == "mean":
                out[n > 0] = mean[n > 0]
            else:
                sq = np.bincount(g, weights=(v - mean[g]) ** 2, minlength=self.ngroups)
                two = n > 1
                out[two] = np.sqrt(sq[two] / (n[two] - 1))
            return out
        v, g, starts = self.sorted_values(col)
        n = np.diff(starts)
        has = n > 0
        if how == "min":
            out[has] = v[starts[:-1][has]]
        elif how == "max":
            out[has] = v[starts[1:][has] - 1]
        elif how == "median":
            return self.quantile(col, 0.5)
        else:
            raise ValueError(f"unknown reduction {how!r}")
        return out

    def quantile(self, col: np.ndarray, q: float) -> np.ndarray:
        """Each group's ``q`` quantile, linear interpolation between the
        order statistics around ``(n - 1) q``."""
        v, _g, starts = self.sorted_values(col)
        n = np.diff(starts)
        out = np.full(self.ngroups, np.nan)
        has = n > 0
        pos = (n[has] - 1) * q
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, n[has] - 1)
        frac = pos - lo
        a, b = v[starts[:-1][has] + lo], v[starts[:-1][has] + hi]
        out[has] = np.where(frac > 0, a + (b - a) * frac, a)
        return out

    def transform(self, col: np.ndarray, how: str) -> np.ndarray:
        """``groupby(...)[col].transform(how)``: each row its group's
        statistic (NaN for a row with a missing key)."""
        stat = self.reduce(col, how)
        out = np.full(len(self.codes), np.nan)
        out[self.valid] = stat[self.codes[self.valid]]
        return out


def value_counts(col: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``Series.value_counts()``: distinct present values by descending
    count, ties in first-seen order; ``(values, counts)``."""
    col = np.asarray(col)
    ok = ~isna(col)
    present = col[ok]
    codes, n = _codes([present])
    counts = np.bincount(codes, minlength=n)
    first = np.full(n, len(present), np.int64)
    np.minimum.at(first, codes, np.arange(len(present)))
    seen = np.argsort(first, kind="stable")
    order = seen[np.argsort(-counts[seen], kind="stable")]
    return present[first[order]], counts[order]
