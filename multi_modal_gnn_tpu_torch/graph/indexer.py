"""Entity ID <-> contiguous node index (``multi_modal_gnn_tpu/graph/indexer.py``),
in numpy.

IDs are canonicalized as the JAX indexer does (:func:`canonical_id`): an
integral float and a numeric string become the int (``1``, ``1.0`` and
``"1"`` are one node; the synthetic ICD-9 codes ``"250"`` are the ints
``250``), other strings are stripped.  :meth:`NodeIndexer.to_dict` writes
the JAX JSON.
"""

from __future__ import annotations

import math
from typing import Dict, Hashable, Iterable, List, Optional, Tuple

import numpy as np

# every NaN id canonicalizes to this one object, so dict lookups find it
_NAN = float("nan")


def canonical_id(entity_id) -> Hashable:
    """Normalize an entity identifier: float-integers -> int, strip strings,
    numeric strings -> their number."""
    if isinstance(entity_id, (np.integer, int)):
        return int(entity_id)
    if isinstance(entity_id, (np.floating, float)):
        f = float(entity_id)
        if f != f:
            return _NAN
        return int(f) if f.is_integer() else f
    if isinstance(entity_id, str):
        s = entity_id.strip()
        try:
            f = float(s)
        except ValueError:
            return s
        if not math.isfinite(f):
            return s
        return int(f) if f.is_integer() else f
    return entity_id


def _canonical_int_values(arr: np.ndarray) -> Optional[np.ndarray]:
    """``arr`` as int64 when every element canonicalizes to an int (integer
    arrays, integral floats), else None."""
    if np.issubdtype(arr.dtype, np.integer):
        if arr.dtype.kind == "u" and arr.size and int(arr.max()) > np.iinfo(np.int64).max:
            return None
        return arr.astype(np.int64, copy=False)
    if np.issubdtype(arr.dtype, np.floating):
        with np.errstate(invalid="ignore"):
            as_int = arr.astype(np.int64)
            if bool(np.all(as_int == arr)):
                return as_int
    return None


def _factorize(arr: np.ndarray) -> Tuple[np.ndarray, List[Hashable]]:
    """``(codes, uniques)``: the distinct raw values in first-seen order,
    canonicalized, and each element's position among them."""
    ints = _canonical_int_values(arr) if arr.dtype != object else None
    values = ints if ints is not None else arr
    if values.dtype != object:
        uniq, first, inverse = np.unique(values, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(order), dtype=np.int64)
        rank[order] = np.arange(len(order))
        codes = rank[inverse.ravel()]
        uniq = uniq[order]
    else:
        seen: Dict = {}
        codes = np.fromiter((seen.setdefault(v, len(seen)) for v in values), np.int64, len(values))
        uniq = list(seen)
    if ints is not None:
        return codes, [int(u) for u in uniq]
    return codes, [canonical_id(u.item() if isinstance(u, np.generic) else u) for u in uniq]


class NodeIndexer:
    """Bidirectional entity-ID <-> dense-index map for one node type."""

    def __init__(self, node_type: str = "node"):
        self.node_type = node_type
        self.id_to_index: Dict[Hashable, int] = {}
        self.index_to_id: List[Hashable] = []

    def __len__(self) -> int:
        return len(self.index_to_id)

    def __contains__(self, entity_id) -> bool:
        return canonical_id(entity_id) in self.id_to_index

    def add(self, entity_id) -> int:
        """Add one entity (idempotent); returns its dense index."""
        cid = canonical_id(entity_id)
        idx = self.id_to_index.get(cid)
        if idx is None:
            idx = len(self.index_to_id)
            self.id_to_index[cid] = idx
            self.index_to_id.append(cid)
        return idx

    def add_many(self, entity_ids: Iterable) -> np.ndarray:
        """Add entities in first-seen order; returns their indices (int32)."""
        arr = np.asarray(entity_ids if hasattr(entity_ids, "__len__") else list(entity_ids))
        codes, uniques = _factorize(arr.ravel())
        remap = np.asarray([self.add(u) for u in uniques], dtype=np.int64)
        return remap[codes].astype(np.int32) if len(codes) else np.zeros(0, np.int32)

    def index_of(self, entity_id) -> int:
        return self.id_to_index[canonical_id(entity_id)]

    def get(self, entity_id, default: Optional[int] = None) -> Optional[int]:
        return self.id_to_index.get(canonical_id(entity_id), default)

    def lookup_many(self, entity_ids: Iterable) -> np.ndarray:
        """Indices of many IDs (int32); unknown IDs map to -1."""
        arr = np.asarray(entity_ids if hasattr(entity_ids, "__len__") else list(entity_ids))
        if not arr.size:
            return np.zeros(0, np.int32)
        codes, uniques = _factorize(arr.ravel())
        found = np.asarray([self.id_to_index.get(u, -1) for u in uniques], dtype=np.int32)
        return found[codes]

    def id_of(self, index: int):
        return self.index_to_id[index]

    def to_dict(self) -> dict:
        return {
            "node_type": self.node_type,
            "ids": [str(i) if not isinstance(i, (int, float)) else i for i in self.index_to_id],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NodeIndexer":
        idx = cls(node_type=d.get("node_type", "node"))
        for entity_id in d["ids"]:
            idx.add(entity_id)
        return idx
