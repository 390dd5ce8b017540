"""The fused pair head (``multi_modal_gnn_tpu/ops/pallas_pairhead.py``
``fused_pair_head``): the factored edge head's MLP over a slot-major batch
with no per-pair intermediate in device memory, forward (K4f) or backward
(K4b, which recomputes the forward and stores nothing).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from multi_modal_gnn_tpu_torch.ops.pairhead_kernels import pair_head_bwd, pair_head_fwd


class _FusedPairHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj_p, proj_l, w1, b1, w2, b2, plan_args):
        ctx.plan_args = plan_args
        ctx.save_for_backward(proj_p, proj_l, w1, b1, w2, b2)
        return pair_head_fwd(proj_p, proj_l, w1, b1, w2, b2, *plan_args[:-1])

    @staticmethod
    def backward(ctx, g_out):
        *plan, num_windows = ctx.plan_args
        grads = pair_head_bwd(
            *ctx.saved_tensors, *plan, num_windows, g_out.float().contiguous()
        )
        return (*grads, None)


def fused_pair_head(
    proj_p: torch.Tensor,
    proj_l: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    lab_idx: torch.Tensor,
    win_local: torch.Tensor,
    win_tile_map: torch.Tensor,
    seed: Sequence[int],
    tile_mask: Optional[torch.Tensor],
    lab_block_map: Optional[torch.Tensor],
    num_windows: int,
    rate: float = 0.0,
    lab_block_rows: int = 0,
    lab_span_mode: bool = False,
) -> torch.Tensor:
    """``out[slot] = MLP(relu(proj_p[patient(slot)] + proj_l[lab(slot)]))``.

    Slot-major contract: slot ``e`` of tile ``t`` addresses patient
    ``win_tile_map[t] * 128 + win_local[e]``; padding slots carry
    ``win_local == 128`` and output 0.  ``w1`` is ``[H0, H1]`` (the flax
    kernel layout), ``w2`` ``[H1]``, ``b2`` ``[1]``.  ``seed`` (two uint32)
    drives the dropout generator; ``rate=0`` turns dropout off.

    ``tile_mask`` (int32 [num_tiles] or None): tiles with mask 0 output 0 and
    get no gradient.  The caller guarantees that the consumer ignores this
    head's value at every real slot of such a tile (the degree gate).

    ``lab_block_rows > 0`` with ``lab_span_mode`` and ``lab_block_map`` (the
    per-tile lab row bases of ``regroup_slots_by_lab_span``): every tile reads
    its labs from rows ``[base, base + lab_block_rows)``; a lab outside them
    reads a zero row."""
    if lab_block_rows and lab_block_map is None:
        # a zeros-default map would silently gather every tile from block 0
        raise ValueError(
            "lab_block_rows > 0 requires the span-bounded plan's lab_block_map "
            "(graph/hetero.py regroup_slots_by_lab_span)"
        )
    if lab_block_rows and not lab_span_mode:
        raise ValueError("aligned lab blocks are not ported; use span mode (lab_span_mode=True)")
    plan_args = (
        lab_idx, win_local, win_tile_map, tuple(int(s) for s in seed), tile_mask,
        lab_block_map, float(rate), int(lab_block_rows), int(num_windows),
    )
    return _FusedPairHead.apply(proj_p, proj_l, w1, b1, w2, b2, plan_args)
