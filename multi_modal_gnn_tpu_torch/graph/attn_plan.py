"""Combined per-destination-type plans for the HGT flash-attention kernels
(numpy copy of ``multi_modal_gnn_tpu/graph/attn_plan.py``, held equal to it
by ``tests/test_torch_attention.py``).

HGT normalizes its softmax over every relation into a destination node, so
the kernels (``ops/attention.py``) run on one virtual relation per
destination type: the relations' key / value projections are stacked into
one virtual source table (relation ``r``'s sources at rows
``[src_offsets[r], src_offsets[r] + num_src_r)``), and the combined edge
list gets two windowed layouts (``graph/hetero.py``):

* ``fwd`` — windows over destinations, gathers from the virtual source
  table: the forward (K6) and ``dq`` (K7);
* ``rev`` — windows over virtual source rows, gathers from destinations:
  ``dk`` / ``dv`` (K8).

A side whose gather table has more than :data:`ATTN_RESIDENT_MAX_ROWS` rows
also gets a span layout, climbing :data:`_SPAN_LADDER` until the span packer
accepts it; a group whose span layout is refused has no plan and runs the
segment tier.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.graph.hetero import (
    HeteroGraph,
    _tensor,
    build_src_span_plan,
    build_window_plan,
)
from multi_modal_gnn_tpu_torch.graph.schema import EdgeTypeKey, is_reverse, mirror_edge_type

logger = logging.getLogger(__name__)

# gather tables up to this many rows take the windowed layout ("resident");
# above it, the span layout
ATTN_RESIDENT_MAX_ROWS = 512
# base span height; sparse groups climb the ladder (multiples of the base)
ATTN_SPAN_ROWS = 128
_SPAN_LADDER = (1, 2, 4, 8, 16, 32)


@dataclass
class AttnSidePlan:
    """One direction's layout: windows over the output side, gathers from
    the other.  ``win_*`` is always present, ``span_*`` when the gather side
    is over :data:`ATTN_RESIDENT_MAX_ROWS` (the kernels then run on it)."""

    win_src: torch.Tensor  # int32 [E_win] gather-side row per slot
    win_local: torch.Tensor  # int32 [E_win] output row within its window (128 = pad)
    win_tile_map: torch.Tensor  # int32 [E_win / TILE_E] window of each tile
    span_src: Optional[torch.Tensor] = None
    span_local: Optional[torch.Tensor] = None
    span_tile_map: Optional[torch.Tensor] = None
    span_base: Optional[torch.Tensor] = None  # int32 per-tile gather-table row base
    num_windows: int = 0
    span_rows: int = 0

    @property
    def use_span(self) -> bool:
        return self.span_rows > 0

    def arrays(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(src, local, tile_map)`` of the layout the kernels run on."""
        if self.use_span:
            return self.span_src, self.span_local, self.span_tile_map
        return self.win_src, self.win_local, self.win_tile_map

    def to(self, device) -> "AttnSidePlan":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


@dataclass
class AttnGroupPlan:
    """The combined plan of every relation into one destination type."""

    fwd: AttnSidePlan  # windows = destinations, gathers = virtual sources
    rev: AttnSidePlan  # windows = virtual sources, gathers = destinations
    rel_keys: Tuple[EdgeTypeKey, ...] = ()
    src_offsets: Tuple[int, ...] = ()  # base row of each relation's sources
    num_src_total: int = 0
    num_dst: int = 0
    num_edges: int = 0

    def to(self, device) -> "AttnGroupPlan":
        return dataclasses.replace(self, fwd=self.fwd.to(device), rev=self.rev.to(device))


def _host_pairs(graph: HeteroGraph, et: EdgeTypeKey) -> Tuple[np.ndarray, np.ndarray]:
    """The valid ``(src, dst)`` of ``et`` in the order the JAX bundle's
    ``host_edges`` holds them: a forward relation's own dst-sorted edges; a
    reverse relation's are its mirror's, swapped."""
    mirror = is_reverse(et)
    es = graph.edges[mirror_edge_type(et) if mirror else et]
    n = es.num_valid
    src, dst = es.src[:n].cpu().numpy(), es.dst[:n].cpu().numpy()
    return (dst, src) if mirror else (src, dst)


def _build_side(
    gather_ids: np.ndarray,
    out_ids: np.ndarray,
    num_out: int,
    num_gather: int,
    span_rows: int,
    resident_max: int,
) -> Optional[AttnSidePlan]:
    """Window plan over ``out_ids`` (and a span layout of the gathers when
    the gather side is over ``resident_max`` rows), or None when no rung of
    the span ladder passes the packer's inflation guard."""
    order = np.argsort(out_ids, kind="stable")
    g_sorted = np.asarray(gather_ids, np.int32)[order]
    o_sorted = np.asarray(out_ids, np.int32)[order]
    win_src, win_local, win_tile_map, num_windows = build_window_plan(g_sorted, o_sorted, num_out)
    span = None
    if num_gather > resident_max and len(g_sorted):
        for mult in _SPAN_LADDER:
            span = build_src_span_plan(win_src, win_local, win_tile_map, num_gather, span_rows * mult)
            if span is not None:
                span_rows = span_rows * mult
                break
        if span is None:
            return None
    return AttnSidePlan(
        win_src=_tensor(win_src),
        win_local=_tensor(win_local),
        win_tile_map=_tensor(win_tile_map),
        span_src=_tensor(span[0]) if span is not None else None,
        span_local=_tensor(span[1]) if span is not None else None,
        span_tile_map=_tensor(span[2]) if span is not None else None,
        span_base=_tensor(span[3]) if span is not None else None,
        num_windows=int(num_windows),
        span_rows=int(span_rows) if span is not None else 0,
    )


def build_attn_plans(
    graph: HeteroGraph,
    span_rows: int = ATTN_SPAN_ROWS,
    resident_max: int = ATTN_RESIDENT_MAX_ROWS,
) -> Dict[str, AttnGroupPlan]:
    """One :class:`AttnGroupPlan` per destination type, on the CPU.  Groups
    and their relations follow ``graph.edge_types``, the grouping of the
    segment tier (``models/hgt.py``)."""
    counts = graph.node_count_map
    incoming: Dict[str, list] = {}
    for et in graph.edge_types:
        incoming.setdefault(et[2], []).append(et)

    plans: Dict[str, AttnGroupPlan] = {}
    for dst_t, ets in incoming.items():
        srcs, dsts, offsets = [], [], []
        base = 0
        for et in ets:
            s, d = _host_pairs(graph, et)
            offsets.append(base)
            srcs.append(s.astype(np.int64) + base)
            dsts.append(d)
            base += counts[et[0]]
        csrc = np.concatenate(srcs).astype(np.int32)
        cdst = np.concatenate(dsts).astype(np.int32)
        num_dst = counts[dst_t]
        fwd = _build_side(csrc, cdst, num_dst, base, span_rows, resident_max)
        rev = _build_side(cdst, csrc, base, num_dst, span_rows, resident_max)
        if fwd is None or rev is None:
            logger.warning(
                "attn plan: span layout unavailable for group %s (tile-split inflation); "
                "the segment tier serves it", dst_t,
            )
            continue
        plans[dst_t] = AttnGroupPlan(
            fwd=fwd, rev=rev, rel_keys=tuple(ets), src_offsets=tuple(offsets),
            num_src_total=int(base), num_dst=int(num_dst), num_edges=int(len(csrc)),
        )
        logger.info(
            "attn plan[%s]: %d edges, %d dst windows (%s), %d rev windows (%s)",
            dst_t, len(csrc), fwd.num_windows, "span" if fwd.use_span else "resident",
            rev.num_windows, "span" if rev.use_span else "resident",
        )
    return plans


def ensure_attn_plans(graph: HeteroGraph, config) -> HeteroGraph:
    """``graph`` with flash-attention plans attached when the configured
    model runs them (HGT, ``model.use_pallas``, ``model.extras.hgt_flash``
    not off), on the graph's device; otherwise ``graph`` unchanged."""
    mc = config.model
    if mc.architecture != "HGT" or not mc.use_pallas or mc.hgt_flash == "off":
        return graph
    if graph.attn_plans is not None:
        return graph
    plans = build_attn_plans(graph)
    if not plans:
        return graph
    device = graph.patient_lab_degree.device
    return dataclasses.replace(
        graph, attn_plans={dst_t: plan.to(device) for dst_t, plan in plans.items()}
    )
