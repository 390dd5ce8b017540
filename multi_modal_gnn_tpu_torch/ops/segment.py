"""Neighbor aggregation with the JAX package's tier dispatch
(``multi_modal_gnn_tpu/ops/segment.py`` ``aggregate_neighbors``).

With ``impl="pallas"`` (``model.use_pallas``) a relation takes the first tier
that applies, in this order:

* ``dense``: the relation has a dense mean-normalized adjacency — one
  ``torch.matmul``;
* ``fused_table``: a small source table (:func:`fused_table_applicable`) —
  kernel K2f;
* ``span``: a span plan and the mirror relation's windowed plan
  (:func:`span_dma_applicable`) — kernel K3;
* ``paired`` (mirror relation present) or ``windowed`` — kernel K1.

``impl="xla"`` and ``max`` aggregation take the segment path
(``index_add_`` / ``scatter_reduce``).  The gates match the JAX ones in its
``take`` gather mode, so both packages pick the same tier on the same graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_modal_gnn_tpu_torch.graph.hetero import EdgeSet
from multi_modal_gnn_tpu_torch.ops.segment_kernels import (
    fused_table_segment_sum,
    segment_sum_windowed,
    span_segment_sum,
)

FUSED_TABLE_MAX_ROWS = 2048
FUSED_TABLE_MAX_BYTES = 4 * 1024 * 1024


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean over segments; empty segments give 0."""
    total = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    count = segment_sum(ones, segment_ids, num_segments).clamp_min(1.0)
    return total / (count[:, None] if data.dim() > 1 else count)


def fused_table_applicable(edges: EdgeSet, feature_dim: Optional[int] = None, itemsize: int = 4) -> bool:
    if edges.win_src is None:
        return False
    limit = FUSED_TABLE_MAX_ROWS
    if feature_dim is not None:
        limit = min(limit, FUSED_TABLE_MAX_BYTES // max(feature_dim * itemsize, 1))
    return edges.num_src <= limit


def span_dma_applicable(edges: EdgeSet, edges_rev: Optional[EdgeSet]) -> bool:
    """The span tier needs the span plan and the mirror relation's windowed
    plan (its backward, in training, is the reverse aggregation)."""
    return (
        edges.span_rows > 0
        and edges.span_src is not None
        and edges_rev is not None
        and edges_rev.win_src is not None
    )


def aggregation_tier(
    edges: EdgeSet,
    edges_rev: Optional[EdgeSet],
    feature_dim: int,
    aggregation: str = "mean",
    impl: str = "pallas",
    itemsize: int = 4,
) -> str:
    """The tier :func:`aggregate_neighbors` takes for this relation."""
    if impl != "pallas" or aggregation not in ("mean", "sum"):
        return "xla"
    if edges.dense_adj is not None:
        return "dense"
    if fused_table_applicable(edges, feature_dim, itemsize):
        return "fused_table"
    if span_dma_applicable(edges, edges_rev):
        return "span"
    if edges.win_src is None:
        return "xla"
    return "paired" if edges_rev is not None and edges_rev.win_src is not None else "windowed"


def _finish(total: torch.Tensor, edges: EdgeSet, aggregation: str, dtype) -> torch.Tensor:
    out = total[: edges.num_dst]
    if aggregation == "mean":
        out = out / edges.dst_count.clamp_min(1.0)[:, None]
    return out.to(dtype)


def aggregate_neighbors(
    x_src: torch.Tensor,
    edges: EdgeSet,
    aggregation: str = "mean",
    impl: str = "xla",
    edges_rev: Optional[EdgeSet] = None,
) -> torch.Tensor:
    """``[num_dst, D]`` aggregate of source features over each destination's
    in-neighbors (0 for isolated destinations)."""
    tier = aggregation_tier(
        edges, edges_rev, x_src.shape[1], aggregation, impl, x_src.element_size()
    )
    if tier == "dense":
        out = torch.matmul(edges.dense_adj.to(x_src.dtype), x_src)
        if aggregation == "sum":
            out = out * edges.dst_count.clamp_min(1.0)[:, None]
        return out
    if tier == "fused_table":
        total = fused_table_segment_sum(
            x_src, edges.win_src, edges.win_local, edges.win_tile_map, edges.num_windows
        )
        return _finish(total, edges, aggregation, x_src.dtype)
    if tier == "span":
        total = span_segment_sum(
            x_src, edges.span_src, edges.span_local, edges.span_tile_map, edges.span_base,
            edges.num_windows, edges.span_rows,
        )
        return _finish(total, edges, aggregation, x_src.dtype)
    if tier in ("paired", "windowed"):
        total = segment_sum_windowed(
            x_src, edges.win_src, edges.win_local, edges.win_tile_map, edges.num_windows
        )
        return _finish(total, edges, aggregation, x_src.dtype)

    # segment path: padding edges point at the dummy segment num_dst
    gathered = x_src.index_select(0, edges.src.long())
    num_segments = edges.num_dst + 1
    if aggregation in ("mean", "sum"):
        total = segment_sum(gathered, edges.dst, num_segments)[: edges.num_dst]
        if aggregation == "sum":
            return total
        return total / edges.dst_count.clamp_min(1.0).to(total.dtype)[:, None]
    if aggregation == "max":
        gathered = torch.where(
            edges.mask[:, None] > 0, gathered, torch.full_like(gathered, float("-inf"))
        )
        seg = torch.full(
            (num_segments, x_src.shape[1]), float("-inf"), dtype=x_src.dtype, device=x_src.device
        )
        index = edges.dst.long()[:, None].expand(-1, x_src.shape[1])
        seg = seg.scatter_reduce(0, index, gathered, reduce="amax")[: edges.num_dst]
        return torch.where(torch.isfinite(seg), seg, torch.zeros_like(seg))
    raise ValueError(f"Unknown aggregation: {aggregation}")
