"""Edge-set plans and the heterogeneous graph as plain dataclasses of tensors.

Numpy copies of the JAX package's host-side plan builders
(``multi_modal_gnn_tpu/graph/hetero.py``), held equal to them by
``tests/test_torch_plans.py``:

* :func:`pad_edge_set` — dst-sorted padded COO + CSR, plus every plan;
* :func:`build_window_plan` — the windowed layout: each ``TILE_E``-slot tile
  maps to one ``WINDOW``-row output window, pad slots carry
  ``win_local == WINDOW``;
* :func:`build_src_span_plan` — the span layout: each tile's real sources
  lie in one ``span_rows``-row block of the source table;
* :func:`build_dense_adjacency` — the mean-normalized dense adjacency;
* :func:`build_gather_plan` — the windowed layout of a row gather's backward
  (:class:`GatherPlan`).

:class:`EdgeSet` and :class:`HeteroGraph` keep the JAX field names; their
tensors are built on the CPU and moved with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.graph.schema import EdgeTypeKey

WINDOW = 128  # output rows per window
TILE_E = 1024  # slots per tile; every tile's destinations lie in one window
# span plans: below SPAN_MIN_SRC source rows the fused-table tier serves the
# relation; above SPAN_MAX_INFLATION slot growth the plan is refused
SPAN_MIN_SRC = 4096
SPAN_MAX_INFLATION = 0.25
# span-plan table bases are multiples of this
SPAN_BASE_ALIGN = 16


def _round_up(n: int, multiple: int) -> int:
    if multiple <= 0:
        return n
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def _tensor(a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@dataclass
class EdgeSet:
    """One relation: dst-sorted padded COO + CSR, and its aggregation plans.

    ``dst == num_dst`` marks padding in ``dst``; ``win_local == WINDOW`` and
    ``span_local == WINDOW`` mark pad slots in the windowed and span plans.
    """

    src: torch.Tensor  # int32 [E_pad]
    dst: torch.Tensor  # int32 [E_pad]
    mask: torch.Tensor  # float32 [E_pad]
    val: Optional[torch.Tensor]  # float32 [E_pad] or None
    dst_count: torch.Tensor  # float32 [num_dst] valid in-degree
    row_ptr: torch.Tensor  # int32 [num_dst + 1]
    win_src: Optional[torch.Tensor] = None  # int32 [E_win]
    win_local: Optional[torch.Tensor] = None  # int32 [E_win]
    win_tile_map: Optional[torch.Tensor] = None  # int32 [E_win / TILE_E]
    dense_adj: Optional[torch.Tensor] = None  # float32 [num_dst, num_src]
    span_src: Optional[torch.Tensor] = None  # int32 [E_span]
    span_local: Optional[torch.Tensor] = None  # int32 [E_span]
    span_tile_map: Optional[torch.Tensor] = None  # int32 [E_span / TILE_E]
    span_base: Optional[torch.Tensor] = None  # int32 [E_span / TILE_E]
    num_valid: int = 0
    num_src: int = 0
    num_dst: int = 0
    num_windows: int = 0
    span_rows: int = 0  # 0 = no span plan

    def to(self, device) -> "EdgeSet":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


@dataclass
class HeteroGraph:
    edges: Dict[EdgeTypeKey, EdgeSet]
    patient_lab_degree: torch.Tensor  # int32 [num_patients]
    node_counts: Tuple[Tuple[str, int], ...] = ()
    # HGT flash-attention plans per destination type (graph/attn_plan.py)
    attn_plans: Optional[Dict[str, Any]] = None

    @property
    def node_count_map(self) -> Dict[str, int]:
        return dict(self.node_counts)

    def num_nodes(self, node_type: str) -> int:
        return self.node_count_map[node_type]

    @property
    def node_types(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.node_counts)

    @property
    def edge_types(self) -> Tuple[EdgeTypeKey, ...]:
        return tuple(self.edges.keys())

    def to(self, device) -> "HeteroGraph":
        return dataclasses.replace(
            self,
            edges={et: es.to(device) for et, es in self.edges.items()},
            patient_lab_degree=self.patient_lab_degree.to(device),
            attn_plans=None if self.attn_plans is None else {
                dst_t: plan.to(device) for dst_t, plan in self.attn_plans.items()
            },
        )


def pad_edge_set(
    src: np.ndarray,
    dst: np.ndarray,
    num_src: int,
    num_dst: int,
    val: Optional[np.ndarray] = None,
    pad_multiple: int = 1024,
    dense_max_bytes: int = 0,
    src_span_rows: int = 0,
) -> EdgeSet:
    """Build an :class:`EdgeSet` from host COO arrays."""
    src = np.asarray(src, dtype=np.int32).ravel()
    dst = np.asarray(dst, dtype=np.int32).ravel()
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    if val is not None:
        val = np.asarray(val, dtype=np.float32).ravel()
        if val.shape != src.shape:
            raise ValueError(f"val shape mismatch: {val.shape} vs {src.shape}")
    e = int(src.shape[0])
    if e and (src.min() < 0 or src.max() >= num_src):
        raise ValueError(f"src indices out of range [0, {num_src})")
    if e and (dst.min() < 0 or dst.max() >= num_dst):
        raise ValueError(f"dst indices out of range [0, {num_dst})")

    counts_int = np.bincount(dst, minlength=num_dst) if e else np.zeros(num_dst, np.int64)
    if e:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        if val is not None:
            val = val[order]
    counts = counts_int.astype(np.float32)
    row_ptr = np.zeros(num_dst + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(counts_int).astype(np.int32)

    e_pad = _round_up(e, pad_multiple) if pad_multiple else max(e, 1)
    pad = e_pad - e
    src_p = np.concatenate([src, np.zeros(pad, dtype=np.int32)])
    dst_p = np.concatenate([dst, np.full(pad, num_dst, dtype=np.int32)])
    mask_p = np.concatenate([np.ones(e, np.float32), np.zeros(pad, np.float32)])
    val_p = None if val is None else np.concatenate([val, np.zeros(pad, np.float32)])

    win_src, win_local, win_tile_map, num_windows = build_window_plan(src, dst, num_dst)
    dense = build_dense_adjacency(src, dst, num_src, num_dst, counts, dense_max_bytes)
    span = None
    if src_span_rows and dense is None and num_src >= SPAN_MIN_SRC and e:
        span = build_src_span_plan(win_src, win_local, win_tile_map, num_src, src_span_rows)
    return EdgeSet(
        src=_tensor(src_p),
        dst=_tensor(dst_p),
        mask=_tensor(mask_p),
        val=_tensor(val_p),
        dst_count=_tensor(counts),
        row_ptr=_tensor(row_ptr),
        win_src=_tensor(win_src),
        win_local=_tensor(win_local),
        win_tile_map=_tensor(win_tile_map),
        dense_adj=_tensor(dense),
        span_src=_tensor(span[0]) if span is not None else None,
        span_local=_tensor(span[1]) if span is not None else None,
        span_tile_map=_tensor(span[2]) if span is not None else None,
        span_base=_tensor(span[3]) if span is not None else None,
        num_valid=e,
        num_src=int(num_src),
        num_dst=int(num_dst),
        num_windows=num_windows,
        span_rows=int(src_span_rows) if span is not None else 0,
    )


def build_dense_adjacency(
    src: np.ndarray,
    dst: np.ndarray,
    num_src: int,
    num_dst: int,
    counts: np.ndarray,
    dense_max_bytes: int,
) -> Optional[np.ndarray]:
    """``A[dst, src] = multiplicity / in-degree``, or None over the budget.
    ``A @ x`` is then the segment mean (duplicate edges add mass)."""
    if dense_max_bytes <= 0 or num_src * num_dst * 4 > dense_max_bytes:
        return None
    flat = np.asarray(dst, np.int64) * num_src + np.asarray(src, np.int64)
    a = (
        np.bincount(flat, minlength=num_dst * num_src)
        .astype(np.float32)
        .reshape(num_dst, num_src)
    )
    a /= np.maximum(counts, 1.0)[:, None]
    return a


def build_window_plan(
    src: np.ndarray,
    dst: np.ndarray,
    num_dst: int,
    window: int = WINDOW,
    tile_e: int = TILE_E,
):
    """Regroup dst-sorted edges so each ``tile_e``-slot tile maps to one
    ``window``-row output window.  Every window's run is padded to a whole
    number of tiles (at least one); pad slots carry ``win_local == window``.

    Returns ``(win_src, win_local, win_tile_map, num_windows)``."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    num_windows = max((num_dst + window - 1) // window, 1)
    boundaries = np.searchsorted(dst, np.arange(num_windows + 1) * window)
    src_parts, local_parts, tile_map = [], [], []
    for w in range(num_windows):
        lo, hi = int(boundaries[w]), int(boundaries[w + 1])
        n = hi - lo
        n_pad = max(tile_e, ((n + tile_e - 1) // tile_e) * tile_e)
        pad = n_pad - n
        src_parts.append(np.concatenate([src[lo:hi], np.zeros(pad, np.int32)]))
        local_parts.append(
            np.concatenate([dst[lo:hi] - w * window, np.full(pad, window, np.int32)])
        )
        tile_map.append(np.full(n_pad // tile_e, w, np.int32))
    return (
        np.concatenate(src_parts).astype(np.int32),
        np.concatenate(local_parts).astype(np.int32),
        np.concatenate(tile_map).astype(np.int32),
        num_windows,
    )


def _pad_and_sort_tiles(slot_moves, tile_meta, tile_windows, out_len, win_tile_map, num_tiles):
    """Windows with no real slot still get one pad tile, so the window
    sequence stays complete; then tiles re-sort by window and
    ``slot_moves`` follows the tile permutation."""
    seen_windows = set(tile_windows)
    for w in range(int(win_tile_map.max()) + 1 if num_tiles else 0):
        if w not in seen_windows:
            tile_meta.append(0)
            tile_windows.append(w)
            out_len += TILE_E
    t_order = np.argsort(np.asarray(tile_windows), kind="stable")
    if not np.array_equal(t_order, np.arange(len(t_order))):
        tile_new_pos = np.empty(len(t_order), dtype=np.int64)
        tile_new_pos[t_order] = np.arange(len(t_order))
        old_tile = slot_moves // TILE_E
        off = slot_moves % TILE_E
        m = slot_moves >= 0
        slot_moves[m] = tile_new_pos[old_tile[m]] * TILE_E + off[m]
        tile_meta = list(np.asarray(tile_meta)[t_order])
        tile_windows = list(np.asarray(tile_windows)[t_order])
    return slot_moves, tile_meta, tile_windows, out_len


def regroup_slots_by_lab_span(
    win_local: np.ndarray,
    win_tile_map: np.ndarray,
    lab_idx: np.ndarray,
    num_labs: int,
    block_rows: int = WINDOW,
):
    """Re-lay a windowed plan so every tile's real slots address rows inside
    one ``block_rows``-row span of a table, at a ``SPAN_BASE_ALIGN``-aligned
    base: each window's real slots are sorted by row, and tiles are packed
    greedily, closing when full or when the next row leaves the span.

    Returns ``(slot_moves, new_len, local2, tile_map2, base)``:
    ``slot_moves[old_slot]`` is the new slot of each real old slot (-1 for
    old padding), ``base[t]`` the table row base of new tile ``t``."""
    if block_rows % SPAN_BASE_ALIGN:
        raise ValueError(
            f"span-mode block_rows must be a multiple of {SPAN_BASE_ALIGN}, got {block_rows}"
        )
    win_local = np.asarray(win_local)
    win_tile_map = np.asarray(win_tile_map)
    lab_idx = np.asarray(lab_idx)
    e_win = len(win_local)
    num_tiles = e_win // TILE_E
    real = win_local < WINDOW

    labs_pad = max(-(-max(num_labs, 1) // 128) * 128, block_rows)
    max_base = labs_pad - block_rows

    slot_window = np.repeat(win_tile_map, TILE_E)
    order = np.lexsort((np.arange(e_win), lab_idx, slot_window))
    order = order[real[order]]
    g_win = slot_window[order]
    g_lab = lab_idx[order]
    n = len(order)
    if n:
        w_starts = np.nonzero(np.r_[True, g_win[1:] != g_win[:-1]])[0]
        w_ends = np.r_[w_starts[1:], n]
    else:
        w_starts = w_ends = np.zeros(0, dtype=np.int64)

    slot_moves = np.full(e_win, -1, dtype=np.int64)
    tile_bases: list = []
    tile_windows: list = []
    out_len = 0
    for s, e in zip(w_starts, w_ends):
        w = int(g_win[s])
        i = int(s)
        while i < e:
            base = min((int(g_lab[i]) // SPAN_BASE_ALIGN) * SPAN_BASE_ALIGN, max_base)
            cut = i + int(np.searchsorted(g_lab[i:e], base + block_rows, "left"))
            j = min(i + TILE_E, cut)
            slot_moves[order[i:j]] = out_len + np.arange(j - i)
            tile_bases.append(base)
            tile_windows.append(w)
            out_len += TILE_E
            i = j

    slot_moves, tile_bases, tile_windows, out_len = _pad_and_sort_tiles(
        slot_moves, tile_bases, tile_windows, out_len, win_tile_map, num_tiles
    )
    local2 = np.full(out_len, WINDOW, dtype=np.int32)
    m = slot_moves >= 0
    local2[slot_moves[m]] = win_local[m]
    return (
        slot_moves,
        out_len,
        local2,
        np.asarray(tile_windows, dtype=np.int32),
        np.asarray(tile_bases, dtype=np.int32),
    )


@dataclass
class GatherPlan:
    """Windowed layout for the backward of a row gather ``y = x[idx]``: its
    cotangent ``dx[r] = sum_{p: idx[p] == r} g[p]`` is a windowed segment sum
    over (position -> idx) pairs.

    ``identity``: the batch is already laid out in this plan's slot order
    (slot-major train batches), so the backward needs no reorder gather.
    ``lab_block_map`` / ``lab_block_rows`` / ``lab_span_mode``: span-bounded
    lab tiles (:func:`regroup_slots_by_lab_span`); ``lab_block_map[t]`` is the
    lab-table row base of tile ``t``."""

    win_src: torch.Tensor  # int32 [E_win] positions into the gathered batch
    win_local: torch.Tensor  # int32 [E_win] target row offset within window
    win_tile_map: torch.Tensor  # int32 [E_win / TILE_E]
    num_windows: int = 0
    num_rows: int = 0
    identity: bool = False
    lab_block_map: Optional[torch.Tensor] = None  # int32 [E_win / TILE_E]
    lab_block_rows: int = 0
    lab_span_mode: bool = False

    def to(self, device) -> "GatherPlan":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


def build_gather_plan(idx: np.ndarray, num_rows: int) -> GatherPlan:
    """Plan the backward of ``x[idx]`` (host-side, once)."""
    idx = np.asarray(idx, dtype=np.int32)
    order = np.argsort(idx, kind="stable").astype(np.int32)
    win_src, win_local, win_tile_map, num_windows = build_window_plan(order, idx[order], num_rows)
    return GatherPlan(
        win_src=_tensor(win_src),
        win_local=_tensor(win_local),
        win_tile_map=_tensor(win_tile_map),
        num_windows=num_windows,
        num_rows=int(num_rows),
    )


def build_src_span_plan(
    win_src: np.ndarray,
    win_local: np.ndarray,
    win_tile_map: np.ndarray,
    num_src: int,
    span_rows: int,
):
    """Span plan for big-source relations: :func:`regroup_slots_by_lab_span`
    pointed at the source axis.  Window accumulation is order-free, so each
    window's slots may be re-sorted by source.

    Returns ``(span_src, span_local, span_tile_map, span_base)``, or None when
    tile splitting grows the slot count beyond ``SPAN_MAX_INFLATION``."""
    slot_moves, new_len, local2, tile_map2, base = regroup_slots_by_lab_span(
        win_local, win_tile_map, win_src, num_src, block_rows=span_rows
    )
    if new_len > len(win_local) * (1.0 + SPAN_MAX_INFLATION):
        return None
    src2 = np.zeros(new_len, dtype=np.int32)
    m = slot_moves >= 0
    src2[slot_moves[m]] = np.asarray(win_src, dtype=np.int32)[m]
    return src2, local2, tile_map2, base
