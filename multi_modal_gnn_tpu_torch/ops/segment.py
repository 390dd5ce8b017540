"""Neighbor aggregation with the JAX package's tier dispatch
(``multi_modal_gnn_tpu/ops/segment.py`` ``aggregate_neighbors``).

With ``impl="pallas"`` (``model.use_pallas``) a relation takes the first tier
that applies, in this order:

* ``dense``: the relation has a dense mean-normalized adjacency — one
  ``torch.matmul``;
* ``fused_table``: a small source table (:func:`fused_table_applicable`) —
  kernel K2f;
* ``span``: a span plan of at most ``SPAN_MAX_ROWS`` rows and the mirror
  relation's windowed plan (:func:`span_dma_applicable`) — kernel K3;
* ``paired`` (mirror relation present) or ``windowed`` — kernel K1.

``impl="xla"`` and ``max`` aggregation take the segment path
(``index_add_`` / ``scatter_reduce``).  The gates match the JAX ones in its
``take`` gather mode, so both packages pick the same tier on the same graph.

Each kernel tier is a ``torch.autograd.Function`` whose backward is a kernel,
as the JAX ``custom_vjp``s are: ``fused_table`` runs K2b; ``span`` and
``paired`` run K1 over the mirror relation's windowed plan on the scaled
upstream gradient (``d x_src[s] = sum_{e: src e = s} g[dst e] / deg``);
``windowed`` (no mirror plan) gathers the gradient rows back to the slots
and scatter-adds them.  :func:`take_with_plan` is a row gather whose backward
is K1 over a :class:`~multi_modal_gnn_tpu_torch.graph.hetero.GatherPlan`.

bfloat16 features (the model's compute dtype) round where the JAX tiers
round (``ops/pallas_segment.py``): every kernel sums in float32, and each
tier divides by the in-degree in float32 and casts back to the features'
dtype.  In the backward, the span, paired and windowed tiers scale the
gradient in float32 and round it to bfloat16 before K1 (or the scatter)
sums it in float32; the fused-table tier hands K2b the scaled gradient in
float32, as JAX does (``pallas_segment.py:443-454``); a planned gather's
backward runs K1 on the gradient in its own dtype.  The dense tier multiplies in float32
and casts back.  The segment path (``impl="xla"``) and a gather without a
plan (:func:`gather_rows`, whose backward is a scatter-add) sum bfloat16
rows in float32 and round each total once, as the kernels do: torch's
``index_add_`` into a bfloat16 tensor rounds at every add on the card, in
the order its atomics land, so a lab row's gradient summed from thousands
of edges carried an error of a few percent that changed from run to run
(JAX's scatter on the CPU rounds at every add too, in edge order).  On the
CPU torch's ``index_add_`` already sums bfloat16 rows in float32, so the CPU
results do not change.
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW, EdgeSet, GatherPlan
from multi_modal_gnn_tpu_torch.ops.segment_kernels import (
    SPAN_MAX_ROWS,
    fused_table_segment_sum,
    fused_table_segment_sum_bwd,
    segment_sum_windowed,
    span_segment_sum,
)

FUSED_TABLE_MAX_ROWS = 2048
FUSED_TABLE_MAX_BYTES = 4 * 1024 * 1024


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of ``data``'s rows per segment; bfloat16 rows are summed in
    float32 and each total rounded once (see the module docstring)."""
    acc = torch.float32 if data.dtype == torch.bfloat16 else data.dtype
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc, device=data.device)
    return out.index_add_(0, segment_ids.long(), data.to(acc)).to(data.dtype)


class _GatherRows(torch.autograd.Function):
    """``x[idx]`` whose backward sums the gradient rows in float32 and
    rounds each total once to ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dx = torch.zeros((ctx.rows,) + tuple(g.shape[1:]), dtype=torch.float32, device=g.device)
        return dx.index_add_(0, idx, g.float()).to(g.dtype), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along rows.  For bfloat16 rows the backward's scatter-add
    sums in float32 and rounds once (see the module docstring); other
    dtypes take ``index_select``'s own backward."""
    idx = idx.long()
    if x.dtype == torch.bfloat16:
        return _GatherRows.apply(x, idx)
    return x.index_select(0, idx)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean over segments; empty segments give 0."""
    total = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    count = segment_sum(ones, segment_ids, num_segments).clamp_min(1.0)
    return total / (count[:, None] if data.dim() > 1 else count)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Softmax of ``logits [E, ...]`` within each segment (the HGT segment
    tier).  The max shift carries no gradient, and a segment whose max is
    not finite (only ``-inf`` logits, or none) is shifted by 0."""
    ids = segment_ids.long()
    index = ids.reshape((-1,) + (1,) * (logits.dim() - 1)).expand_as(logits)
    seg_max = torch.full(
        (num_segments,) + tuple(logits.shape[1:]), float("-inf"), dtype=logits.dtype,
        device=logits.device,
    ).scatter_reduce(0, index, logits.detach(), reduce="amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    exp = torch.exp(logits - seg_max.index_select(0, ids))
    denom = segment_sum(exp, ids, num_segments)
    return exp / denom.index_select(0, ids).clamp_min(1e-16)


def fused_table_applicable(edges: EdgeSet, feature_dim: Optional[int] = None, itemsize: int = 4) -> bool:
    if edges.win_src is None:
        return False
    limit = FUSED_TABLE_MAX_ROWS
    if feature_dim is not None:
        limit = min(limit, FUSED_TABLE_MAX_BYTES // max(feature_dim * itemsize, 1))
    return edges.num_src <= limit


def span_dma_applicable(edges: EdgeSet, edges_rev: Optional[EdgeSet]) -> bool:
    """The span tier needs the span plan, no more span rows than K3 stages
    (``SPAN_MAX_ROWS``; taller spans take the paired tier, where the JAX
    kernel stages any height), and the mirror relation's windowed plan (its
    backward, in training, is the reverse aggregation)."""
    return (
        0 < edges.span_rows <= SPAN_MAX_ROWS
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


def _forward_sum(x: torch.Tensor, edges: EdgeSet, tier: str) -> torch.Tensor:
    if tier == "fused_table":
        return fused_table_segment_sum(
            x, edges.win_src, edges.win_local, edges.win_tile_map, edges.num_windows
        )
    if tier == "span":
        return span_segment_sum(
            x, edges.span_src, edges.span_local, edges.span_tile_map, edges.span_base,
            edges.num_windows, edges.span_rows,
        )
    return segment_sum_windowed(
        x, edges.win_src, edges.win_local, edges.win_tile_map, edges.num_windows
    )


def _backward_sum(g: torch.Tensor, edges: EdgeSet, edges_rev: Optional[EdgeSet], tier: str):
    """``d x_src`` (float32 sums) from the degree-scaled, contiguous
    destination gradient ``g [num_dst, D]`` (float32 for the fused-table
    tier, the features' dtype otherwise)."""
    if tier == "fused_table":
        return fused_table_segment_sum_bwd(
            g, edges.win_src, edges.win_local, edges.win_tile_map, edges.num_src
        )
    if tier in ("span", "paired"):
        return segment_sum_windowed(
            g, edges_rev.win_src, edges_rev.win_local, edges_rev.win_tile_map,
            edges_rev.num_windows,
        )[: edges_rev.num_dst]
    # windowed: the slot rows' gradient, scatter-added onto their sources
    real = edges.win_local < WINDOW
    window_of_slot = torch.repeat_interleave(edges.win_tile_map.long(), TILE_E)[real]
    rows = window_of_slot * WINDOW + edges.win_local[real].long()
    dx = torch.zeros(edges.num_src, g.shape[1], dtype=torch.float32, device=g.device)
    return dx.index_add_(0, edges.win_src[real].long(), g.index_select(0, rows).float())


class _KernelAggregate(torch.autograd.Function):
    """A kernel tier's aggregation with its kernel backward."""

    @staticmethod
    def forward(ctx, x, edges, edges_rev, tier, aggregation):
        ctx.edges, ctx.edges_rev, ctx.tier, ctx.aggregation = edges, edges_rev, tier, aggregation
        ctx.dtype = x.dtype
        return _finish(_forward_sum(x, edges, tier), edges, aggregation, x.dtype)

    @staticmethod
    def backward(ctx, g):
        edges = ctx.edges
        g = g.float()
        if ctx.aggregation == "mean":
            g = g / edges.dst_count.clamp_min(1.0)[:, None]
        if ctx.tier != "fused_table":
            g = g.to(ctx.dtype)
        dx = _backward_sum(g.contiguous(), edges, ctx.edges_rev, ctx.tier)
        return dx.to(ctx.dtype), None, None, None, None


class _TakeWithPlan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, plan):
        ctx.plan, ctx.dtype = plan, x.dtype
        return x.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        g = g.contiguous()
        # identity plans (slot-major batches): the gradient is already in slot order
        src = None if plan.identity else plan.win_src
        dx = segment_sum_windowed(g, src, plan.win_local, plan.win_tile_map, plan.num_windows)
        return dx[: plan.num_rows].to(ctx.dtype), None, None


def take_with_plan(x: torch.Tensor, idx: torch.Tensor, plan: Optional[GatherPlan]) -> torch.Tensor:
    """``x[idx]`` whose backward runs K1 over ``plan`` (a plain gather
    without one)."""
    if plan is None:
        return gather_rows(x, idx)
    return _TakeWithPlan.apply(x, idx, plan)


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
        # the adjacency in the features' dtype, the product and sum in float32
        adj = edges.dense_adj.to(x_src.dtype)
        out = torch.matmul(adj.float(), x_src.float()) if x_src.dtype == torch.bfloat16 else adj @ x_src
        if aggregation == "sum":
            out = out * edges.dst_count.clamp_min(1.0)[:, None]
        return out.to(x_src.dtype)
    if tier in ("fused_table", "span", "paired", "windowed"):
        return _KernelAggregate.apply(x_src, edges, edges_rev, tier, aggregation)

    # segment path: padding edges point at the dummy segment num_dst
    gathered = gather_rows(x_src, edges.src)
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
