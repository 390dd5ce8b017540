"""The observed-value context channel of both architectures
(``multi_modal_gnn_tpu/models/context.py``).

Before layer 0 each side gets one value-weighted aggregation over the
patient->lab edges whose values this forward may see:

    ctx[p] = mean_{visible e: p->l} val_e * x[l],   (+ visible share)
    ctx[l] = mean_{visible e: p->l} val_e * x[p],   (+ visible share)

projected by ``vctx_patient`` / ``vctx_lab`` (``Linear(hidden + 1,
hidden)``) and added to the node features.  ``EdgeSet.val_vis``, which the
trainer sets on every forward, hides the supervised, val and test edges'
values, so no prediction reads its own target.

Two routes compute the sums.  The plain one, JAX's form, is ``index_add_``
over gathered rows: padding edges carry ``dst == num_dst``, so the lab
gather clamps them to the last row (a finite row times a zero weight) and
the lab sums put them in a dummy segment ``num_dst``.  On the card, where
the edge set carries its :class:`~multi_modal_gnn_tpu_torch.graph.hetero.ValuePlan`
(the trainer attaches it), each side is one ``torch.sparse.mm`` of a CSR
matrix over the valid edges, its structure built once and its values
``val * vis`` set per forward, and its backward the product with the
transposed CSR: ``index_add_`` sends 5M edges' patient rows into 500 lab rows
through float atomics at ``scale_100k``, 27 ms a forward on an H100
(``PERF.md`` §6).

Under edge-sharded data parallelism (``axis``, JAX's ``axis_name``) the
edge set is the rank's chunk: each route sums over it, and ``wsum`` and
``cnt`` are all-reduced on both sides (in float32, before a bfloat16 table's
rounding) (JAX ``context.py:32-87``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from multi_modal_gnn_tpu_torch.graph.hetero import EdgeSet, HeteroGraph
from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT, PATIENT_LAB
from multi_modal_gnn_tpu_torch.parallel.collectives import all_reduce_, all_reduce_sum


class _CsrProduct(torch.autograd.Function):
    """``a @ x`` for a constant CSR ``a``; the backward is ``a_t @ g``."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        ctx.a_t = a_t
        return torch.sparse.mm(a, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.a_t, g.contiguous()), None, None


def _segment_totals(weights: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Sums of ``weights`` over the CSR rows ``row_ptr``: differences of a
    float64 running sum (exact for 0 / 1 weights below 2^53 edges, where a
    float32 one stops counting at 2^24), cast back to ``weights``' type."""
    run = torch.zeros(weights.shape[0] + 1, dtype=torch.float64, device=weights.device)
    run[1:] = torch.cumsum(weights, 0, dtype=torch.float64)
    ptr = row_ptr.long()
    return (run[ptr[1:]] - run[ptr[:-1]]).to(weights.dtype)


def csr_route(es: EdgeSet, device: torch.device) -> bool:
    """The sparse-product route: on the card, where the plan is attached."""
    return es.value_plan is not None and device.type == "cuda"


class _Sums:
    """Both sides' value-weighted sums and visible counts over one edge set:
    ``lab(x_p) -> (wsum_l, cnt_l)``, ``patient(x_l) -> (wsum_p, cnt_p)``.

    Each side's values are cast to the dtype of the table it weights, as
    JAX casts them (``context.py:40``, ``:73``).  A bfloat16 table's sums
    run in float32 and are rounded to bfloat16 once, where JAX rounds at
    every add (a stated deviation, ``CHANGES.md``).  The plain route rounds
    each product ``x[e] * v[e]`` to bfloat16 as JAX does; the sparse route
    multiplies float32 copies of the rows and values in float32 and drops
    that rounding: the card's bfloat16 sparse product rounds its partial
    sums in bfloat16 (``chip_smoke.py`` phase 23 (f) prints its error)."""

    def __init__(self, es: EdgeSet, device, axis=None):
        self.es = es
        self.axis = axis
        self.vis = es.val_vis if es.val_vis is not None else es.mask
        self.val_vis = es.val * self.vis
        self.csr = csr_route(es, device)
        self._matrices = {}

    def _combine(self, wsum: torch.Tensor, cnt: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """The float32 sums all-reduced over the data axis (if any), then
        rounded to ``dtype``."""
        if self.axis is not None:
            wsum = all_reduce_sum(wsum, self.axis)
            cnt = all_reduce_(cnt.clone(), self.axis)
        return wsum.to(dtype), cnt

    def _by(self, dtype):
        """The CSR matrices (by lab, by patient) of ``val * vis`` rounded to
        ``dtype``, as float32."""
        if dtype not in self._matrices:
            es, plan = self.es, self.es.value_plan
            e = es.num_valid
            v = self.val_vis[:e].to(dtype).float()
            # the structure is the graph's own, valid by construction
            by_lab = torch.sparse_csr_tensor(
                es.row_ptr, es.src[:e], v, (es.num_dst, es.num_src), check_invariants=False
            )
            by_patient = torch.sparse_csr_tensor(
                plan.src_row_ptr, plan.src_sorted_dst, v[plan.src_order], (es.num_src, es.num_dst),
                check_invariants=False,
            )
            self._matrices[dtype] = (by_lab, by_patient)
        return self._matrices[dtype]

    def lab(self, x_p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        es = self.es
        if self.csr:
            by_lab, by_patient = self._by(x_p.dtype)
            wsum = _CsrProduct.apply(x_p.float(), by_lab, by_patient)
            return self._combine(wsum, _segment_totals(self.vis[: es.num_valid], es.row_ptr), x_p.dtype)
        dst = es.dst.long()
        rows = (x_p.index_select(0, es.src.long()) * self.val_vis.to(x_p.dtype)[:, None]).float()
        wsum = torch.zeros(es.num_dst + 1, x_p.shape[1], device=x_p.device)
        wsum = wsum.index_add_(0, dst, rows)[: es.num_dst]
        cnt = torch.zeros(es.num_dst + 1, dtype=self.vis.dtype, device=self.vis.device)
        return self._combine(wsum, cnt.index_add_(0, dst, self.vis)[: es.num_dst], x_p.dtype)

    def patient(self, x_l: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        es = self.es
        if self.csr:
            plan = es.value_plan
            by_lab, by_patient = self._by(x_l.dtype)
            wsum = _CsrProduct.apply(x_l.float(), by_patient, by_lab)
            cnt = _segment_totals(self.vis[: es.num_valid][plan.src_order], plan.src_row_ptr)
            return self._combine(wsum, cnt, x_l.dtype)
        src = es.src.long()
        rows = x_l.index_select(0, es.dst.clamp_max(es.num_dst - 1).long()) * self.val_vis.to(x_l.dtype)[:, None]
        rows = rows.float()
        wsum = torch.zeros(es.num_src, x_l.shape[1], device=x_l.device).index_add_(0, src, rows)
        cnt = torch.zeros(es.num_src, dtype=self.vis.dtype, device=self.vis.device)
        return self._combine(wsum, cnt.index_add_(0, src, self.vis), x_l.dtype)


def _mean(wsum: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    return wsum / cnt.clamp_min(1.0)[:, None].to(wsum.dtype)


def patient_value_context(x_l: torch.Tensor, es: EdgeSet, axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each patient's mean of ``val * x_l[lab]`` over its visible edges
    ``[num_patients, D]``, its visible count ``[num_patients]``)."""
    wsum, cnt = _Sums(es, x_l.device, axis).patient(x_l)
    return _mean(wsum, cnt), cnt


def inject_value_context(
    x_dict: Dict[str, torch.Tensor], graph: HeteroGraph, vctx_patient: nn.Module, vctx_lab: nn.Module,
    axis=None,
) -> Dict[str, torch.Tensor]:
    """``x_dict`` with the value channel added to the patient and lab
    features (unchanged when the graph has no patient->lab values)."""
    es = graph.edges.get(PATIENT_LAB)
    if es is None or es.val is None:
        return x_dict
    x_p, x_l = x_dict[PATIENT], x_dict[LAB]
    sums = _Sums(es, x_p.device, axis)
    wsum_l, cnt_l = sums.lab(x_p)
    wsum_p, cnt_p = sums.patient(x_l)

    def with_share(wsum, cnt, total):
        return torch.cat([_mean(wsum, cnt), (cnt / float(total)).to(wsum.dtype)[:, None]], dim=-1)

    out = dict(x_dict)
    out[PATIENT] = x_p + vctx_patient(with_share(wsum_p, cnt_p, es.num_dst))
    out[LAB] = x_l + vctx_lab(with_share(wsum_l, cnt_l, es.num_src))
    return out
