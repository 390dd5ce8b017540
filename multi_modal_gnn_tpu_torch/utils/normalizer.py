"""Per-lab value normalization and outlier removal
(``multi_modal_gnn_tpu/utils/normalizer.py``) on numpy columns.

Statistics are pandas' grouped ones: groups in sorted key order, missing
values skipped, the standard deviation with ``ddof=1`` (a single value
gives a scale of 0), quantiles by linear interpolation.  The fitted state
is the ``lab_id`` / ``center`` / ``scale`` / ``method`` table that
``inference.Denormalizer`` reads (interim ``normalizer.npz``).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from multi_modal_gnn_tpu_torch.utils.frame import GroupBy, Table, objects, row_codes

logger = logging.getLogger(__name__)

_METHODS = ("zscore", "minmax", "robust", "none")


class LabNormalizer:
    """Fit / transform / inverse-transform per-group normalization.

    Methods:
      * ``zscore``: (x - mean) / std        (std == 0 -> x - mean)
      * ``minmax``: (x - min) / (max - min) (range == 0 -> 0)
      * ``robust``: (x - median) / IQR      (IQR == 0 -> x - median)
      * ``none``:   identity
    """

    def __init__(self, method: str = "zscore"):
        if method not in _METHODS:
            raise ValueError(f"Unknown normalization method: {method}")
        self.method = method
        self.stats: Dict[object, Optional[dict]] = {}

    def fit_frame(self, table: Table, value_col: str, group_col: str) -> "LabNormalizer":
        """Fit statistics for every group in one pass."""
        values = np.asarray(table[value_col], np.float64)
        keep = ~np.isnan(values)
        clean = {group_col: np.asarray(table[group_col])[keep], value_col: values[keep]}
        if self.method == "none":  # every group, in first-seen order
            for gid in dict.fromkeys(clean[group_col].tolist()):
                self.stats[gid] = {}
            return self
        g = GroupBy(clean, [group_col])
        groups = g.key_values[group_col].tolist()
        v = clean[value_col]
        if self.method == "zscore":
            center = g.reduce(v, "mean")
            scale = np.nan_to_num(g.reduce(v, "std"), nan=0.0)
        elif self.method == "minmax":
            center = g.reduce(v, "min")
            scale = g.reduce(v, "max") - center
        else:  # robust
            center = g.reduce(v, "median")
            scale = g.quantile(v, 0.75) - g.quantile(v, 0.25)
        for gid, c, s in zip(groups, center.tolist(), scale.tolist()):
            self.stats[gid] = {"center": float(c), "scale": float(s)}
        return self

    def transform_frame(self, table: Table, value_col: str, group_col: str) -> np.ndarray:
        """Transform a column; rows of unknown groups pass through."""
        values = np.asarray(table[value_col], np.float64).copy()
        if self.method == "none":
            return values
        fitted = {gid: s for gid, s in self.stats.items() if s}
        keys = list(fitted)
        key_col = np.asarray(keys) if all(isinstance(k, (int, float)) for k in keys) else objects(keys)
        row_code, key_code = row_codes({"g": np.asarray(table[group_col])}, ["g"], {"g": key_col})
        slot = np.full(int(max(row_code.max(initial=-1), key_code.max(initial=-1))) + 1, -1, np.int64)
        slot[key_code] = np.arange(len(keys))
        idx = slot[row_code]
        known = idx >= 0
        center = np.asarray([fitted[k]["center"] for k in keys] + [np.nan])[idx]
        scale = np.asarray([fitted[k]["scale"] for k in keys] + [np.nan])[idx]
        shifted = values - center
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = shifted / np.where(scale != 0, scale, np.nan)
        if self.method == "minmax":
            normalized = np.where(scale != 0, ratio, 0.0)  # range 0 -> 0
        else:
            normalized = np.where(scale != 0, ratio, shifted)
        values[known] = normalized[known]
        return values

    def fit_transform_frame(self, table: Table, value_col: str, group_col: str) -> np.ndarray:
        self.fit_frame(table, value_col, group_col)
        return self.transform_frame(table, value_col, group_col)

    def fit(self, values, lab_id) -> None:
        """Fit one lab from its values."""
        v = np.asarray(values, np.float64)
        self.fit_frame({"g": np.zeros(len(v), np.int64), "v": v}, "v", "g")
        stats = self.stats.pop(0, None)
        if stats is None:
            logger.warning("No valid values for lab %s", lab_id)
        self.stats[lab_id] = stats

    def transform(self, values, lab_id) -> np.ndarray:
        v = np.asarray(values, np.float64)
        if self.method == "none":
            return v
        if self.stats.get(lab_id) is None:
            logger.warning("No statistics for lab %s; returning original values", lab_id)
            return v
        center, scale = self._center(lab_id), self._scale(lab_id)
        if scale == 0 or np.isnan(scale):
            return v * 0 if self.method == "minmax" else v - center
        return (v - center) / scale

    def fit_transform(self, values, lab_id) -> np.ndarray:
        self.fit(values, lab_id)
        return self.transform(values, lab_id)

    def inverse_transform(self, normalized, lab_id) -> np.ndarray:
        v = np.asarray(normalized, np.float64)
        if self.method == "none" or self.stats.get(lab_id) is None:
            return v
        center, scale = self._center(lab_id), self._scale(lab_id)
        if scale == 0 or np.isnan(scale):
            # transform's degenerate scale: shifted by center (scale 1), or
            # collapsed to 0 (minmax)
            return v * 0 + center if self.method == "minmax" else v + center
        return v * scale + center

    def to_frame(self) -> Table:
        """The fitted table: ``lab_id``, ``center``, ``scale``, ``method``."""
        rows = [(gid, s.get("center", 0.0), s.get("scale", 1.0)) for gid, s in self.stats.items() if s is not None]
        ids = [r[0] for r in rows]
        lab_id = np.asarray(ids) if ids and all(isinstance(i, (int, np.integer)) for i in ids) else objects(ids)
        return {
            "lab_id": lab_id,
            "center": np.asarray([r[1] for r in rows], np.float64),
            "scale": np.asarray([r[2] for r in rows], np.float64),
            "method": objects([self.method] * len(rows)),
        }

    @classmethod
    def from_frame(cls, table: Table) -> "LabNormalizer":
        method = str(table["method"][0]) if len(table["method"]) else "zscore"
        norm = cls(method=method)
        for gid, c, s in zip(np.asarray(table["lab_id"]).tolist(), table["center"], table["scale"]):
            norm.stats[gid] = {"center": float(c), "scale": float(s)}
        return norm

    def _center(self, gid) -> float:
        s = self.stats.get(gid)
        return s.get("center", 0.0) if s else 0.0

    def _scale(self, gid) -> float:
        s = self.stats.get(gid)
        return s.get("scale", 1.0) if s else 1.0


def remove_outliers(values, method: str = "std", threshold: float = 5.0) -> np.ndarray:
    """Outliers set to NaN.  ``std``: beyond mean +/- t * std (ddof 1);
    ``iqr``: beyond [q25 - t * IQR, q75 + t * IQR]."""
    v = np.asarray(values, np.float64).copy()
    g = GroupBy({"g": np.zeros(len(v), np.int64)}, ["g"])
    if method == "std":
        mean, std = g.reduce(v, "mean"), g.reduce(v, "std")
        lo, hi = mean - threshold * std, mean + threshold * std
    elif method == "iqr":
        q25, q75 = g.quantile(v, 0.25), g.quantile(v, 0.75)
        lo, hi = q25 - threshold * (q75 - q25), q75 + threshold * (q75 - q25)
    else:
        raise ValueError(f"Unknown outlier detection method: {method}")
    if not len(v):
        return v
    mask = (v < lo[0]) | (v > hi[0])
    n = int(mask.sum())
    if n:
        logger.info("Removed %d outliers (%.2f%%)", n, 100 * n / len(v))
        v[mask] = np.nan
    return v


def remove_outliers_grouped(table: Table, value_col: str, group_col: str, threshold: float = 5.0) -> np.ndarray:
    """Per-group std-outlier removal: values beyond their group's mean +/-
    ``threshold`` standard deviations (ddof 1; 0 for one value) become NaN.
    Rows of a missing group are kept."""
    g = GroupBy(table, [group_col])
    values = np.asarray(table[value_col], np.float64)
    mean = g.transform(values, "mean")
    std = np.nan_to_num(g.transform(values, "std"), nan=0.0)
    mask = (values < mean - threshold * std) | (values > mean + threshold * std)
    out = values.copy()
    out[mask] = np.nan
    return out
