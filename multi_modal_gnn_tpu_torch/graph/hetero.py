"""Edge-set plans and the heterogeneous graph as plain dataclasses of tensors.

Copies of the JAX package's host-side plan builders
(``multi_modal_gnn_tpu/graph/hetero.py``), held equal to them by
``tests/test_torch_plans.py``; the dst sort, the windowed layout and the
span packer run in the graph core (:mod:`multi_modal_gnn_tpu_torch.native`):

* :func:`pad_edge_set` — dst-sorted padded COO + CSR, plus every plan;
* :func:`build_window_plan` — the windowed layout: each ``TILE_E``-slot tile
  maps to one ``WINDOW``-row output window, pad slots carry
  ``win_local == WINDOW``;
* :func:`build_src_span_plan` — the span layout: each tile's real sources
  lie in one ``span_rows``-row block of the source table;
* :func:`build_dense_adjacency` — the mean-normalized dense adjacency;
* :func:`build_gather_plan` — the windowed layout of a row gather's backward
  (:class:`GatherPlan`);
* :func:`build_value_plan` — an edge set in source order, for the value
  context's sums (:class:`ValuePlan`);
* :func:`build_sharded_window_plans` — the per-shard windowed plans of
  edge-sharded data parallelism (``parallel/sharding.py``).

:class:`EdgeSet` and :class:`HeteroGraph` keep the JAX field names; their
tensors are built on the CPU and moved with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch import native
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
    # float32 [E_pad]: which edges' values a forward may read (the value
    # context channel, models/context.py); the trainer sets it per forward,
    # None reads the structural mask
    val_vis: Optional[torch.Tensor] = None
    # the valid edges in source order, for the value context's sums on the
    # card (build_value_plan; the trainer attaches it)
    value_plan: Optional["ValuePlan"] = None
    # per-shard windowed plans of edge-sharded data parallelism
    # (build_sharded_window_plans, attached by parallel/sharding.py): on the
    # full graph the n shards' plans concatenated ([n * L], [n * L / TILE_E],
    # [n]); on a rank's shard its own chunk, whose K1 block of
    # shard_win_windows windows lands at global window shard_win_offset[0]
    shard_win_src: Optional[torch.Tensor] = None  # int32 global source ids
    shard_win_local: Optional[torch.Tensor] = None  # int32
    shard_win_tile_map: Optional[torch.Tensor] = None  # int32
    shard_win_offset: Optional[torch.Tensor] = None  # int32 first window of each shard
    shard_win_windows: int = 0  # k_max, every shard's window count; 0 = no plan
    # a rank's shard: shard_win_offset[0] as a Python int, so the block is
    # placed without reading the device back
    shard_win_first: int = 0

    def _map(self, fn) -> "EdgeSet":
        """A copy with ``fn`` applied to every tensor and the value plan."""
        return dataclasses.replace(
            self,
            **{
                f.name: fn(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), (torch.Tensor, ValuePlan))
            },
        )

    def to(self, device, non_blocking: bool = False) -> "EdgeSet":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "EdgeSet":
        return self._map(lambda t: t.pin_memory())

    def tensors(self) -> list:
        """Every tensor the edge set holds, its value plan's too."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, ValuePlan):
                out.extend((v.src_order, v.src_row_ptr, v.src_sorted_dst))
        return out


@dataclass
class HeteroGraph:
    edges: Dict[EdgeTypeKey, EdgeSet]
    patient_lab_degree: torch.Tensor  # int32 [num_patients]
    node_counts: Tuple[Tuple[str, int], ...] = ()
    # HGT flash-attention plans per destination type (graph/attn_plan.py)
    attn_plans: Optional[Dict[str, Any]] = None
    # lab index -> name, where the graph artifact records them (graph.npz's
    # sidecar); evaluation names the others Lab_<i>
    lab_names: Optional[Dict[int, str]] = None
    # a Cluster-GCN cluster's first global patient row (training/minibatch.py):
    # its patients are local rows 0.. of the window [base, base + n_local) of
    # the model's patient table; None on a full graph.  A Python int, so the
    # model slices with it without reading the device back
    patient_id_base: Optional[int] = None

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

    def to(self, device, non_blocking: bool = False) -> "HeteroGraph":
        return dataclasses.replace(
            self,
            edges={et: es.to(device, non_blocking) for et, es in self.edges.items()},
            patient_lab_degree=self.patient_lab_degree.to(device, non_blocking=non_blocking),
            attn_plans=None if self.attn_plans is None else {
                dst_t: plan.to(device) for dst_t, plan in self.attn_plans.items()
            },
        )

    def pin_memory(self) -> "HeteroGraph":
        """A copy whose edge sets and degrees lie in page-locked host memory,
        so ``to(device, non_blocking=True)`` copies asynchronously.  Needs
        CUDA (the attention plans stay as they are)."""
        return dataclasses.replace(
            self,
            edges={et: es.pin_memory() for et, es in self.edges.items()},
            patient_lab_degree=self.patient_lab_degree.pin_memory(),
        )

    def tensors(self) -> list:
        """Every tensor of the edge sets and the degrees."""
        out = [self.patient_lab_degree]
        for es in self.edges.values():
            out.extend(es.tensors())
        return out


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

    if e:
        # stable counting sort + counts + CSR in one pass (the graph core)
        order, counts_i32, row_ptr = native.sort_edges_by_dst(dst, num_dst)
        src, dst = src[order], dst[order]
        if val is not None:
            val = val[order]
        counts = counts_i32.astype(np.float32)
    else:
        counts = np.zeros(num_dst, np.float32)
        row_ptr = np.zeros(num_dst + 1, dtype=np.int32)

    e_pad = _round_up(e, pad_multiple) if pad_multiple else max(e, 1)
    pad = e_pad - e
    src_p = np.concatenate([src, np.zeros(pad, dtype=np.int32)])
    dst_p = np.concatenate([dst, np.full(pad, num_dst, dtype=np.int32)])
    mask_p = np.concatenate([np.ones(e, np.float32), np.zeros(pad, np.float32)])
    val_p = None if val is None else np.concatenate([val, np.zeros(pad, np.float32)])

    win_src, win_local, win_tile_map, num_windows = build_window_plan(src, dst, num_dst, row_ptr=row_ptr)
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
    row_ptr: Optional[np.ndarray] = None,
):
    """Regroup dst-sorted edges so each ``tile_e``-slot tile maps to one
    ``window``-row output window (the graph core's ``window_plan``).  Every
    window's run is padded to a whole number of tiles (at least one); pad
    slots carry ``win_local == window``.  ``row_ptr``: the CSR of ``dst``
    where the caller has it.

    Returns ``(win_src, win_local, win_tile_map, num_windows)``."""
    dst = np.asarray(dst, dtype=np.int32)
    if row_ptr is None:
        row_ptr = np.zeros(num_dst + 1, dtype=np.int32)
        row_ptr[1:] = np.cumsum(np.bincount(dst, minlength=num_dst)).astype(np.int32)
    return native.window_plan(src, dst, row_ptr, num_dst, window, tile_e)


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
    greedily, closing when full or when the next row leaves the span (the
    graph core's ``span_plan``).

    Returns ``(slot_moves, new_len, local2, tile_map2, base)``:
    ``slot_moves[old_slot]`` is the new slot of each real old slot (-1 for
    old padding), ``base[t]`` the table row base of new tile ``t``."""
    return native.span_plan(
        win_local, win_tile_map, lab_idx, int(num_labs), int(block_rows), WINDOW, TILE_E, SPAN_BASE_ALIGN
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


@dataclass
class ValuePlan:
    """An edge set's valid edges in source order: with the destination-sorted
    CSR the edge set already holds (``row_ptr``, ``src``), the CSR of its
    transpose, so each side of a value-weighted sum, and its backward, is
    one sparse product whose values are set per step."""

    src_order: torch.Tensor  # int64 [E] valid edge positions, stably sorted by source
    src_row_ptr: torch.Tensor  # int32 [num_src + 1]
    src_sorted_dst: torch.Tensor  # int32 [E] destination of each edge in that order

    def to(self, device, non_blocking: bool = False) -> "ValuePlan":
        return ValuePlan(
            *(t.to(device, non_blocking=non_blocking) for t in (self.src_order, self.src_row_ptr, self.src_sorted_dst))
        )

    def pin_memory(self) -> "ValuePlan":
        return ValuePlan(*(t.pin_memory() for t in (self.src_order, self.src_row_ptr, self.src_sorted_dst)))


def build_value_plan(es: EdgeSet) -> ValuePlan:
    """:class:`ValuePlan` of ``es``, on its device (once per graph)."""
    src = es.src[: es.num_valid].long()
    order = torch.argsort(src, stable=True)
    counts = torch.bincount(src, minlength=es.num_src)
    row_ptr = torch.zeros(es.num_src + 1, dtype=torch.int64, device=src.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return ValuePlan(order, row_ptr.int(), es.dst[: es.num_valid][order].contiguous())


def build_sharded_window_plans(
    src_sorted: np.ndarray,
    dst_sorted: np.ndarray,
    num_dst: int,
    n_shards: int,
    window: int = WINDOW,
    tile_e: int = TILE_E,
):
    """Per-shard windowed plans for edge-sharded data parallelism (JAX
    ``build_sharded_window_plans``, ``graph/hetero.py:605-703``).

    The valid dst-sorted edges are cut into ``n_shards`` contiguous,
    near-equal chunks, and each chunk gets the windowed layout of its own
    destinations, relative to its first destination window.  Any disjoint
    cover of the valid edges is correct: each rank sums its chunk and one
    all-reduce restores the total.  Every shard's plan is equalized to the
    same window count ``k_max`` and the same tile count: all-padding tiles
    (``local == window``) extend the window sequence (each local window
    gets at least one tile) and then repeat the last window.  An empty
    shard (fewer edges than shards) gets an all-padding plan at offset 0.

    Returns ``(sh_src, sh_local, sh_tile_map, sh_offset, k_max)``; the
    first three are the shards' plans concatenated, each shard's of equal
    length."""
    e = len(src_sorted)
    bounds = [round(i * e / n_shards) for i in range(n_shards + 1)]
    plans, k_list = [], []
    offsets = np.zeros(n_shards, dtype=np.int32)
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        if hi <= lo:
            plans.append(None)
            k_list.append(0)
            continue
        c_src = np.ascontiguousarray(src_sorted[lo:hi], dtype=np.int32)
        c_dst = np.asarray(dst_sorted[lo:hi], dtype=np.int32)
        first_w = int(c_dst[0]) // window
        k_s = int(c_dst[-1]) // window - first_w + 1
        offsets[s] = first_w
        w_src, w_local, w_tm, _ = build_window_plan(
            c_src, np.ascontiguousarray(c_dst - first_w * window), k_s * window, window=window, tile_e=tile_e,
        )
        plans.append((w_src, w_local, w_tm))
        k_list.append(k_s)

    k_max = max(max(k_list), 1)
    n_tiles = max(k_max if p is None else len(p[2]) + (k_max - k) for p, k in zip(plans, k_list))
    pad_src = np.zeros(tile_e, np.int32)
    pad_local = np.full(tile_e, window, np.int32)
    sh_src, sh_local, sh_tm = [], [], []
    for p, k_s in zip(plans, k_list):
        if p is None:
            src_parts, local_parts = [pad_src] * n_tiles, [pad_local] * n_tiles
            tm = list(range(k_max)) + [k_max - 1] * (n_tiles - k_max)
        else:
            w_src, w_local, w_tm = p
            extra = list(range(k_s, k_max)) + [k_max - 1] * (n_tiles - len(w_tm) - (k_max - k_s))
            src_parts = [w_src] + [pad_src] * len(extra)
            local_parts = [w_local] + [pad_local] * len(extra)
            tm = list(w_tm) + extra
        sh_src.append(np.concatenate(src_parts))
        sh_local.append(np.concatenate(local_parts))
        sh_tm.append(np.asarray(tm, np.int32))
    return (
        np.concatenate(sh_src).astype(np.int32),
        np.concatenate(sh_local).astype(np.int32),
        np.concatenate(sh_tm).astype(np.int32),
        offsets,
        k_max,
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
