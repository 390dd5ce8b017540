"""Collectives over a mesh axis, as autograd Functions (JAX ``psum``,
``pmax``, ``all_gather(tiled=True)``, ``axis_index``).  Each runs in its
axis's process group (``DataAxis.group``; None, the default group).

The gradient convention of the edge-sharded step.  Node tables and
parameters are replicated, each rank's partial sums cover its own edges,
and each rank's loss covers its own batch shard.  A rank's ``backward()``
computes its *share* of the gradient of the one replicated loss: the shares
of a replicated tensor's gradient, summed over the ranks, give its
gradient.  So three things hold together:

* :func:`all_reduce_sum` of forward partials takes an all-reduce (sum) of
  its output gradient's shares as its backward: that sum is the whole
  gradient of the output, which is also the gradient of each rank's
  partial;
* the backward starts from the rank's share of the loss, ``1 / size`` of
  it (:func:`loss_share`);
* the replicated parameters' gradient shares are summed across the ranks
  once, after ``backward()`` (:func:`all_reduce_grads`).

Summing the gradients without the ``1 / size`` share, or sharing the loss
without summing the gradients, gives a wrong gradient; the parity tests
against one process hold it.

The 2-D layout (``parallel/dp2d.py``) adds :func:`gather_rows`, the
patient table's all-gather over the model axis.  The model axis's ranks of
one data index compute the same full-table gradient, so its backward is
the rank's own row slice of the output gradient, not a sum over the model
axis (which would count it ``m`` times); the slice's shares are then summed
over the data axis like any other gradient.

Every collective is the identity without an axis (``None``) or on a
one-rank axis.  :data:`stats` counts each collective's calls, bytes and
host seconds.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

from multi_modal_gnn_tpu_torch.parallel.mesh import DataAxis

# per collective: calls, bytes and host seconds (the call's wall time; gloo
# collectives block the host, NCCL ones are only queued)
stats: Dict[str, Dict[str, float]] = {}


def reset_stats() -> None:
    stats.clear()


def _count(name: str, t: torch.Tensor, seconds: float) -> None:
    s = stats.setdefault(name, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size()
    s["seconds"] += seconds


def _solo(axis) -> bool:
    """No data axis (``None``), or one of one rank: every collective is the
    identity."""
    return axis is None or not axis.distributed


def all_reduce_(t: torch.Tensor, axis: DataAxis, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``t`` (``op`` ``sum`` or ``max``); no
    autograd."""
    if _solo(axis):
        return t
    t0 = time.perf_counter()
    reduce_op = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    dist.all_reduce(t, op=reduce_op, group=axis.group)
    _count(f"all_reduce_{op}", t, time.perf_counter() - t0)
    return t


def all_gather(t: torch.Tensor, axis: DataAxis, name: str = "all_gather") -> torch.Tensor:
    """The axis's ranks' ``t`` concatenated along dim 0 in axis order (JAX
    ``all_gather(tiled=True)``); no autograd.  Counted under ``name``."""
    if _solo(axis):
        return t
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    out = torch.cat(parts)
    _count(name, out, time.perf_counter() - t0)
    return out


def broadcast_(t: torch.Tensor, axis: DataAxis, src: int = 0) -> torch.Tensor:
    """In-place broadcast of the ``t`` of the axis's rank ``src``; no
    autograd.  ``torch.distributed`` names the source by its global rank."""
    if _solo(axis):
        return t
    t0 = time.perf_counter()
    root = src if axis.group is None else dist.get_global_rank(axis.group, src)
    dist.broadcast(t, src=root, group=axis.group)
    _count("broadcast", t, time.perf_counter() - t0)
    return t


def barrier(axis: DataAxis) -> None:
    """Wait until every rank of the axis is here."""
    if not _solo(axis):
        dist.barrier(group=axis.group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        out = all_reduce_(x.clone(), axis, "max")
        ctx.axis = axis
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        # the whole gradient goes to the ranks holding the maximum, split
        # evenly between ties (as torch's amax splits it)
        wins = (x == out).to(g.dtype)
        holders = all_reduce_(wins.clone(), ctx.axis).clamp_min(1.0)
        return all_reduce_(g.clone(), ctx.axis) * wins / holders, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, axis):
        ctx.axis, ctx.rows = axis, shard.shape[0]
        return all_gather(shard, axis, "table_gather")

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.rank * ctx.rows
        return g[lo : lo + ctx.rows].contiguous(), None


def gather_rows(shard: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """The whole table from the axis's row shards, in axis order; its
    backward is this rank's row slice of the output gradient (module
    docstring)."""
    if _solo(axis):
        return shard
    return _GatherRows.apply(shard, axis)


def all_reduce_sum(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """JAX ``psum``: the sum of every rank's ``x``; its backward sums the
    output gradient's shares (module docstring)."""
    if _solo(axis):
        return x
    return _AllReduceSum.apply(x, axis)


def all_reduce_max(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """JAX ``pmax``: the elementwise maximum over the ranks."""
    if _solo(axis):
        return x
    return _AllReduceMax.apply(x, axis)


def axis_index(axis: DataAxis) -> int:
    """JAX ``axis_index``: this rank's position on the axis."""
    return 0 if axis is None else axis.rank


def loss_share(loss: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """This rank's share of the replicated loss, where its backward starts."""
    return loss if _solo(axis) else loss / axis.size


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def all_reduce_grads(params: Iterable[torch.nn.Parameter], axis: DataAxis, scale: float = 1.0) -> None:
    """Sum the parameters' gradient shares over the axis's ranks, one
    all-reduce per dtype and device, and multiply the sums by ``scale``."""
    if _solo(axis):
        return
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            groups.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in groups.values():
        flat = all_reduce_(_flat(grads), axis)
        if scale != 1.0:
            flat.mul_(scale)
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset : offset + n].view_as(g))
            offset += n


def broadcast_module(module: torch.nn.Module, axis: DataAxis, src: int = 0, buffers_only: bool = False) -> None:
    """Make every rank's parameters and buffers (only the floating-point
    buffers with ``buffers_only``) the axis's rank ``src``'s."""
    if _solo(axis):
        return
    tensors = [b for b in module.buffers() if b.is_floating_point()] if buffers_only else (
        list(module.parameters()) + list(module.buffers())
    )
    with torch.no_grad():
        for t in tensors:
            broadcast_(t.data, axis, src)
