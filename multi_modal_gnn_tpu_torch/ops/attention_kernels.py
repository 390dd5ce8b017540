"""Windowed flash-attention kernels (CUDA, ``csrc/attention.cu``): wrappers
and their plain PyTorch versions.

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; any other device raises.  The plan
arrays are one side of an :class:`~multi_modal_gnn_tpu_torch.graph.attn_plan.AttnGroupPlan`
(``side.arrays()``: the span layout where there is one, else the windowed
one); the kernels read rows by index in both, so neither needs padded
tables.  ``q`` is already scaled by ``1 / sqrt(dh)``; heads are the column
blocks of width ``dh = h / num_heads``.

=====================  ===========================================================
wrapper                replaces (``multi_modal_gnn_tpu/ops/pallas_attention.py``)
=====================  ===========================================================
flash_attention_fwd    K6  ``_flash_fwd_call`` (``_fwd_kernel_resident`` / ``_span``)
flash_attention_dq     K7  ``_flash_dq_call`` (``_dq_kernel_resident`` / ``_span``)
flash_attention_dkv    K8  ``_flash_dkv_call`` (``_dkv_kernel_resident`` / ``_span``)
=====================  ===========================================================

K6 runs as three CUDA kernels (row max, sums, finish) and counts as one
launch per call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW
from multi_modal_gnn_tpu_torch.ops.segment_kernels import (
    _check_plan,
    _check_rows,
    _on_cpu,
    _ptr,
    _raise_on,
)

# launches per wrapper: each adds one where it launches its kernel
launch_counts: Dict[str, int] = {
    "flash_attention_fwd": 0,
    "flash_attention_dq": 0,
    "flash_attention_dkv": 0,
}

EMPTY_LSE = 1e30  # the log-sum-exp of a row with no edges
EXP_CLAMP = 60.0  # the backward's bound on exp arguments
_BLOCKS_PER_SM_TARGET = 4


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _slots(src, local, tile_map):
    """``(row, gather)`` of every real slot: its output row and the row it
    gathers."""
    real = local < WINDOW
    window = torch.repeat_interleave(tile_map.long(), TILE_E)[real]
    return window * WINDOW + local[real].long(), src[real].long()


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    return x.reshape(x.shape[0], num_heads, -1)


def flash_attention_fwd_plain(q, k, v, src, local, tile_map, num_windows: int, num_heads: int):
    rows = num_windows * WINDOW
    row, s = _slots(src, local, tile_map)
    logit = (_heads(q, num_heads)[row] * _heads(k, num_heads)[s]).sum(-1)  # [E, nh]
    row_max = torch.full((rows, num_heads), -1e30, dtype=torch.float32, device=q.device)
    row_max = row_max.scatter_reduce(0, row[:, None].expand_as(logit), logit, reduce="amax")
    p = torch.exp(logit - row_max[row])
    den = torch.zeros(rows, num_heads, dtype=torch.float32, device=q.device).index_add_(0, row, p)
    h = q.shape[1]
    out = torch.zeros(rows, h, dtype=torch.float32, device=q.device)
    out.index_add_(0, row, (_heads(v, num_heads)[s] * p[..., None]).reshape(-1, h))
    out = (_heads(out, num_heads) / den.clamp_min(1e-20)[..., None]).reshape(rows, h)
    lse = torch.where(
        den > 0, row_max + torch.log(den.clamp_min(1e-30)), torch.full_like(den, EMPTY_LSE)
    )
    return out, lse


def _probabilities(q, k, v, dout, lse, delta, d, s, num_heads):
    """Per real slot and head: ``(p, dl)`` with ``p = exp(min(q.k - lse,
    60))`` and ``dl = p (dO.v - delta)``, destination ``d``, source ``s``."""
    qd, do = _heads(q, num_heads)[d], _heads(dout, num_heads)[d]
    logit = (qd * _heads(k, num_heads)[s]).sum(-1)
    p = torch.exp(torch.clamp(logit - lse[d], max=EXP_CLAMP))
    dattn = (do * _heads(v, num_heads)[s]).sum(-1)
    return p, p * (dattn - delta[d]), qd, do


def flash_attention_dq_plain(q, k, v, dout, lse, delta, src, local, tile_map, num_windows: int,
                             num_heads: int):
    row, s = _slots(src, local, tile_map)
    _, dl, _, _ = _probabilities(q, k, v, dout, lse, delta, row, s, num_heads)
    h = q.shape[1]
    dq = torch.zeros(num_windows * WINDOW, h, dtype=torch.float32, device=q.device)
    return dq.index_add_(0, row, (dl[..., None] * _heads(k, num_heads)[s]).reshape(-1, h))


def flash_attention_dkv_plain(q, k, v, dout, lse, delta, src, local, tile_map, num_windows: int,
                              num_heads: int):
    row, d = _slots(src, local, tile_map)  # reverse layout: rows are sources
    p, dl, qd, do = _probabilities(q, k, v, dout, lse, delta, d, row, num_heads)
    h = q.shape[1]
    dk = torch.zeros(num_windows * WINDOW, h, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dk.index_add_(0, row, (dl[..., None] * qd).reshape(-1, h))
    dv.index_add_(0, row, (p[..., None] * do).reshape(-1, h))
    return dk, dv


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_tables(name: str, h: int, *tensors) -> None:
    for t in tensors:
        _check_rows(t, name)
        if t.shape[1] != h:
            raise ValueError(f"{name}: rows {t.shape[1]} wide, expected {h}")


def heads_supported(h: int, num_heads: int) -> bool:
    """Whether K6-K8 take ``h`` columns in ``num_heads`` heads: a lane owns 4
    columns and a head's lanes reduce by xor shuffles, so h <= 128 and dh / 4
    a power of two.  The HGT's tier choice asks this before it picks the
    flash tier (``models/hgt.py``)."""
    if num_heads <= 0 or h % num_heads:
        return False
    dh = h // num_heads
    lanes = dh // 4
    return h <= 128 and dh >= 4 and dh % 4 == 0 and lanes & (lanes - 1) == 0


def _check_heads(name: str, h: int, num_heads: int) -> None:
    if not heads_supported(h, num_heads):
        raise ValueError(f"{name}: h={h} with {num_heads} heads is not supported (h <= 128, dh = 4 * 2^n)")


def _check_stats(name: str, num_heads: int, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != num_heads or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 [rows, {num_heads}] statistics")


def _launch_args(name: str, device, src, local, tile_map):
    slots = local.shape[0]
    num_tiles = _check_plan(
        name, device, slots, (src, slots), (local, slots), (tile_map, slots // TILE_E)
    )
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles_per_block = max(1, -(-num_tiles // (sms * _BLOCKS_PER_SM_TARGET)))
    return num_tiles, tiles_per_block


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_attention_fwd(
    q, k, v, src, local, tile_map, num_windows: int, num_heads: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: ``(out [num_windows * 128, h], lse [num_windows * 128, nh])``
    over the forward layout (windows over destinations, gathers from k, v)."""
    name = "flash_attention_fwd"
    if _on_cpu(q, k, v, src, local, tile_map):
        return flash_attention_fwd_plain(q, k, v, src, local, tile_map, num_windows, num_heads)
    h = q.shape[1]
    _check_heads(name, h, num_heads)
    _check_tables(name, h, q, k, v)
    num_tiles, tiles_per_block = _launch_args(name, q.device, src, local, tile_map)
    rows = num_windows * WINDOW
    f32 = dict(dtype=torch.float32, device=q.device)
    logits = torch.empty(local.shape[0], num_heads, **f32)
    row_max = torch.full((rows, num_heads), -1e30, **f32)
    den = torch.zeros(rows, num_heads, **f32)
    out = torch.zeros(rows, h, **f32)
    lse = torch.empty(rows, num_heads, **f32)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_flash_attention_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(src), _ptr(local), _ptr(tile_map), num_tiles,
        tiles_per_block, rows, h, num_heads, _ptr(logits), _ptr(row_max), _ptr(den), _ptr(out),
        _ptr(lse), _stream(q.device),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return out, lse


def flash_attention_dq(
    q, k, v, dout, lse, delta, src, local, tile_map, num_windows: int, num_heads: int
) -> torch.Tensor:
    """K7: ``dq [num_windows * 128, h]`` over the forward layout, from q, dO
    ``[num_dst, h]`` and LSE, delta ``[num_dst, nh]``."""
    name = "flash_attention_dq"
    if _on_cpu(q, k, v, dout, lse, delta, src, local, tile_map):
        return flash_attention_dq_plain(
            q, k, v, dout, lse, delta, src, local, tile_map, num_windows, num_heads
        )
    h = q.shape[1]
    _check_heads(name, h, num_heads)
    _check_tables(name, h, q, k, v, dout)
    _check_stats(name, num_heads, lse, delta)
    num_tiles, tiles_per_block = _launch_args(name, q.device, src, local, tile_map)
    dq = torch.zeros(num_windows * WINDOW, h, dtype=torch.float32, device=q.device)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_flash_attention_dq(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta), _ptr(src), _ptr(local),
        _ptr(tile_map), num_tiles, tiles_per_block, h, num_heads, _ptr(dq), _stream(q.device),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return dq


def flash_attention_dkv(
    q, k, v, dout, lse, delta, src, local, tile_map, num_windows: int, num_heads: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: ``(dk, dv)``, each ``[num_windows * 128, h]``, over the reverse
    layout (windows over virtual sources; ``src`` are destination rows)."""
    name = "flash_attention_dkv"
    if _on_cpu(q, k, v, dout, lse, delta, src, local, tile_map):
        return flash_attention_dkv_plain(
            q, k, v, dout, lse, delta, src, local, tile_map, num_windows, num_heads
        )
    h = q.shape[1]
    _check_heads(name, h, num_heads)
    _check_tables(name, h, q, k, v, dout)
    _check_stats(name, num_heads, lse, delta)
    num_tiles, tiles_per_block = _launch_args(name, q.device, src, local, tile_map)
    dk = torch.zeros(num_windows * WINDOW, h, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_flash_attention_dkv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta), _ptr(src), _ptr(local),
        _ptr(tile_map), num_tiles, tiles_per_block, h, num_heads, _ptr(dk), _ptr(dv),
        _stream(q.device),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return dk, dv
