"""Grouped multi-head attention per destination node over a combined plan
(``multi_modal_gnn_tpu/ops/pallas_attention.py`` ``flash_attention_group``
and ``flash_attention_ref``).

:func:`flash_attention_group` is a ``torch.autograd.Function`` whose forward
is K6 over the plan's forward layout and whose backward computes
``delta = sum_dh(dO * out)`` per head, then K7 (``dq``, forward layout) and
K8 (``dk``, ``dv``, reverse layout): no scatter runs in either direction.
The model's plans hold the forward side with each tile's slots in row
order (``ensure_attn_plans``), so K6 and K7 skip their per-tile sort.
On CPU tensors the kernels' plain versions run instead.
"""

from __future__ import annotations

import math

import torch

from multi_modal_gnn_tpu_torch.graph.attn_plan import AttnGroupPlan
from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW
from multi_modal_gnn_tpu_torch.ops.attention_kernels import (
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
)
from multi_modal_gnn_tpu_torch.ops.segment import segment_softmax, segment_sum


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_s, k, v, plan: AttnGroupPlan, num_heads: int):
        q_s, k, v = q_s.float().contiguous(), k.float().contiguous(), v.float().contiguous()
        out, lse = flash_attention_fwd(q_s, k, v, *plan.fwd.arrays(), plan.fwd.num_windows, num_heads)
        out = out[: plan.num_dst]
        ctx.plan, ctx.num_heads = plan, num_heads
        ctx.save_for_backward(q_s, k, v, out, lse[: plan.num_dst].contiguous())
        return out

    @staticmethod
    def backward(ctx, g):
        q_s, k, v, out, lse = ctx.saved_tensors
        plan, nh = ctx.plan, ctx.num_heads
        dout = g.float().contiguous()
        # delta[d, head] = dO[d] . out[d] per head: the flash backward's constant
        delta = (dout * out).reshape(out.shape[0], nh, -1).sum(-1).contiguous()
        stats = (q_s, k, v, dout, lse, delta)
        dq = flash_attention_dq(*stats, *plan.fwd.arrays(), plan.fwd.num_windows, nh)
        dk, dv = flash_attention_dkv(*stats, *plan.rev.arrays(), plan.rev.num_windows, nh)
        n_src = plan.num_src_total
        return dq[: plan.num_dst], dk[:n_src], dv[:n_src], None, None


def flash_attention_group(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan: AttnGroupPlan, num_heads: int
) -> torch.Tensor:
    """``[num_dst, h]``: per destination and head, the softmax over its
    incoming edges of ``q[dst] . k[src] / sqrt(dh)`` weighting ``v[src]``;
    an empty destination gives 0.  ``q`` is unscaled, ``k`` and ``v`` are
    the relations' projections stacked in ``plan.rel_keys`` order."""
    dh = q.shape[1] // num_heads
    return _FlashAttention.apply(q / math.sqrt(float(dh)), k, v, plan, int(num_heads))


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan: AttnGroupPlan, num_heads: int
) -> torch.Tensor:
    """The plain oracle: per-edge gathers and :func:`segment_softmax` over
    the plan's forward window arrays."""
    side = plan.fwd
    h = q.shape[1]
    dh = h // num_heads
    e = side.win_src.shape[0]
    rows = side.num_windows * WINDOW
    window = torch.repeat_interleave(side.win_tile_map.long(), TILE_E)[:e]
    valid = side.win_local < WINDOW
    dst = torch.where(valid, window * WINDOW + side.win_local.clamp_max(WINDOW - 1).long(), rows)
    q_pad = torch.cat([q, q.new_zeros(rows - q.shape[0], h)])
    q_e = q_pad[dst.clamp_max(rows - 1)].reshape(e, num_heads, dh)
    k_e = k[side.win_src.long()].reshape(e, num_heads, dh)
    v_e = v[side.win_src.long()].reshape(e, num_heads, dh)
    logit = (q_e * k_e).sum(-1) / math.sqrt(float(dh))
    logit = torch.where(valid[:, None], logit, torch.full_like(logit, float("-inf")))
    attn = segment_softmax(logit, dst, rows + 1)
    attn = torch.where(torch.isfinite(logit), attn, torch.zeros_like(attn))
    return segment_sum((v_e * attn[..., None]).reshape(e, h), dst, rows + 1)[: plan.num_dst]
