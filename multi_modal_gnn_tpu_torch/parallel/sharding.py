"""The edge-sharded layout of 1-D data parallelism
(``multi_modal_gnn_tpu/parallel/sharding.py``).

* Each relation's padded, dst-sorted edge arrays (``src``, ``dst``,
  ``mask``, ``val``, ``val_vis``) are cut into ``size`` contiguous equal
  chunks, one a rank; a chunk of the dst-sorted order is still dst-sorted.
  On a rank's shard ``num_valid`` and ``row_ptr`` describe its chunk (the
  valid edges lead the padded arrays, so the chunk's valid edges lead it);
  ``dst_count`` stays the global in-degree, which the mean divides by.
* The per-shard windowed plans (``shard_win_*``,
  :func:`~multi_modal_gnn_tpu_torch.graph.hetero.build_sharded_window_plans`)
  are cut the same way: a rank keeps its own plan and offset.
* The single-device tiers' plans (windowed, span, dense adjacency, the
  HGT's attention plans) are not read on the sharded path and are dropped
  from a shard.
* Node tables and parameters are replicated.
* A supervised batch's arrays are cut into ``size`` chunks too; its gather
  plans are dropped (the pair heads run plain under data parallelism),
  ``vis_positions`` stays whole (the value-context knockout maps the
  global positions into the rank's edge chunk), and ``num_valid`` stays
  the global count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from multi_modal_gnn_tpu_torch import native
from multi_modal_gnn_tpu_torch.graph.hetero import EdgeSet, HeteroGraph, build_sharded_window_plans
from multi_modal_gnn_tpu_torch.graph.schema import EdgeTypeKey, is_reverse, mirror_edge_type
from multi_modal_gnn_tpu_torch.parallel.mesh import DataAxis
from multi_modal_gnn_tpu_torch.training.masker import SplitBatch

# the edge-length arrays a shard cuts; every other tensor of an edge set is
# replicated (dst_count) or rebuilt for the chunk (row_ptr)
EDGE_ARRAYS = ("src", "dst", "mask", "val", "val_vis")
_SHARD_PLAN = ("shard_win_src", "shard_win_local", "shard_win_tile_map")
_SINGLE_DEVICE_PLANS = (
    "win_src", "win_local", "win_tile_map", "dense_adj", "span_src", "span_local", "span_tile_map",
    "span_base", "value_plan",
)


def check_graph_divisible(graph: HeteroGraph, n: int) -> None:
    for et, es in graph.edges.items():
        if es.src.shape[0] % n:
            raise ValueError(
                f"Edge padding of {et} ({es.src.shape[0]}) not divisible by mesh size {n}; "
                f"raise graph.edge_pad_multiple"
            )


def attach_shard_plans(graph: HeteroGraph, host_edges: Dict[EdgeTypeKey, tuple], n_shards: int) -> HeteroGraph:
    """``graph`` with every relation's per-shard windowed plans (JAX
    ``attach_shard_plans``).  ``host_edges`` holds each forward relation's
    valid dst-sorted ``(src, dst, val)``; a reverse relation's plans come
    from the same pairs swapped and re-sorted by the graph core's counting
    sort.  Host copies of the reverse relations themselves are skipped."""
    new_edges = dict(graph.edges)
    for et, (src, dst, _val) in host_edges.items():
        if et not in new_edges or (is_reverse(et) and mirror_edge_type(et) in host_edges):
            continue
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        plan_inputs = [(et, src, dst)]
        rev = mirror_edge_type(et)
        if rev in new_edges:
            order, _, _ = native.sort_edges_by_dst(src, new_edges[rev].num_dst)
            plan_inputs.append((rev, dst[order], src[order]))
        for key, s_sorted, d_sorted in plan_inputs:
            es = new_edges[key]
            sh_src, sh_local, sh_tm, sh_off, k_max = build_sharded_window_plans(
                s_sorted, d_sorted, es.num_dst, n_shards
            )
            new_edges[key] = dataclasses.replace(
                es,
                shard_win_src=torch.from_numpy(sh_src).to(es.src.device),
                shard_win_local=torch.from_numpy(sh_local).to(es.src.device),
                shard_win_tile_map=torch.from_numpy(sh_tm).to(es.src.device),
                shard_win_offset=torch.from_numpy(sh_off).to(es.src.device),
                shard_win_windows=int(k_max),
            )
    return dataclasses.replace(graph, edges=new_edges)


def _chunk(t: Optional[torch.Tensor], rank: int, n: int) -> Optional[torch.Tensor]:
    if t is None:
        return None
    size = t.shape[0] // n
    return t[rank * size : (rank + 1) * size].contiguous()


def edge_set_shard(es: EdgeSet, rank: int, n: int) -> EdgeSet:
    """Rank ``rank``'s chunk of ``es`` (module docstring)."""
    chunk = es.src.shape[0] // n
    lo = rank * chunk
    n_valid = int(min(max(es.num_valid - lo, 0), chunk))
    row_ptr = (es.row_ptr.long() - lo).clamp(0, n_valid).to(es.row_ptr.dtype)
    kwargs = {name: _chunk(getattr(es, name), rank, n) for name in EDGE_ARRAYS}
    kwargs.update({name: None for name in _SINGLE_DEVICE_PLANS})
    if es.shard_win_src is not None:
        kwargs.update({name: _chunk(getattr(es, name), rank, n) for name in _SHARD_PLAN})
        kwargs["shard_win_offset"] = es.shard_win_offset[rank : rank + 1].clone()
        kwargs["shard_win_first"] = int(es.shard_win_offset[rank])
    return dataclasses.replace(es, row_ptr=row_ptr, num_valid=n_valid, num_windows=0, span_rows=0, **kwargs)


def graph_shard(graph: HeteroGraph, rank: int, n: int) -> HeteroGraph:
    """Rank ``rank``'s shard of ``graph``, whose edge sets are cut into
    ``n`` chunks (and so are their shard plans, where attached)."""
    check_graph_divisible(graph, n)
    for et, es in graph.edges.items():
        if es.shard_win_src is not None and es.shard_win_offset.shape[0] != n:
            raise ValueError(f"{et}: shard plans for {es.shard_win_offset.shape[0]} shards, not {n}")
    return dataclasses.replace(
        graph,
        edges={et: edge_set_shard(es, rank, n) for et, es in graph.edges.items()},
        attn_plans=None,
    )


def shard_graph(graph: HeteroGraph, axis: DataAxis, host_edges=None) -> HeteroGraph:
    """This rank's shard of ``graph`` (JAX ``shard_graph``).  With
    ``host_edges`` the per-shard windowed plans are attached first, so
    aggregation runs K1 on every rank (``ops/segment.py``)."""
    check_graph_divisible(graph, axis.size)
    if host_edges is not None:
        graph = attach_shard_plans(graph, host_edges, axis.size)
    return graph_shard(graph, axis.rank, axis.size)


def shard_batch(batch: SplitBatch, axis: DataAxis) -> SplitBatch:
    """This rank's chunk of ``batch`` (module docstring)."""
    n = axis.size
    if batch.valid.shape[0] % n:
        raise ValueError(f"Batch padding {batch.valid.shape[0]} not divisible by mesh size {n}")
    names = ("patient_idx", "lab_idx", "values", "valid", "degrees", "sample_weights")
    return dataclasses.replace(
        batch,
        patient_plan=None,
        lab_plan=None,
        **{name: _chunk(getattr(batch, name), axis.rank, n) for name in names},
    )


def shard_rows(t: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """This rank's chunk of a batch-length tensor (a supervision mask)."""
    return _chunk(t, axis.rank, axis.size)
