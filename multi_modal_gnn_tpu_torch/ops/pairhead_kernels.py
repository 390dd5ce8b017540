"""Fused pair-head kernels (CUDA, ``csrc/pairhead.cu``): wrappers and their
plain PyTorch versions.

==================  ============================================================
wrapper             replaces (``multi_modal_gnn_tpu/ops/pallas_pairhead.py``)
==================  ============================================================
pair_head_fwd       K4f ``_fused_fwd`` / ``_fwd_kernel``
pair_head_bwd       K4b ``_fused_bwd`` / ``_bwd_kernel``
==================  ============================================================

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; any other device raises.  The plain
forward is the head MLP written out on gathered rows; the plain backward is
autograd through it.  Both draw dropout from :func:`dropout_bits`, the
counter-based generator the kernels compute, so kernel and plain version
agree with dropout on.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW
from multi_modal_gnn_tpu_torch.ops.segment_kernels import _check_plan, _on_cpu, _ptr, _raise_on

launch_counts: Dict[str, int] = {"pair_head_fwd": 0, "pair_head_bwd": 0}

H0, H1 = 64, 32  # the head widths the kernels are compiled for
_LAB_PAD = 128
_MAX_SHARED_BYTES = 232_448
_BWD_BLOCKS_PER_SM = 2
_M32 = 0xFFFFFFFF
_BITS_CHUNK = 1 << 18  # slots per chunk of the plain version's bit draws


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# dropout bits: murmur3's finalizer over (seed, slot, layer, column)
# ---------------------------------------------------------------------------


def _fmix32_int(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 ``a`` in [0, 2^32), without int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(seed: Sequence[int], slots: torch.Tensor, layer: int, width: int) -> torch.Tensor:
    """uint32 draws (as int64) for columns ``0..width-1`` of layer ``layer``
    at global slots ``slots``: ``[len(slots), width]``."""
    seed0, seed1 = int(seed[0]) & _M32, int(seed[1]) & _M32
    key = _fmix32(seed0 ^ _fmix32((slots.long() & _M32) ^ _fmix32_int(seed1)))
    ctr = torch.tensor(
        [((layer * 64 + c + 1) * 0x9E3779B9) & _M32 for c in range(width)],
        dtype=torch.int64, device=slots.device,
    )
    return _fmix32(key[:, None] ^ ctr[None, :])


def dropout_params(rate: float) -> Tuple[int, float]:
    """(threshold, scale): keep a draw when ``bits >= threshold`` (unsigned),
    scale kept values by ``1 / (1 - rate)`` (as float32)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    threshold = min(int(rate * (1 << 32)), (1 << 32) - 1)
    return threshold, float(np.float32(1.0) / np.float32(1.0 - rate))


def _keep_mask(seed, slots: torch.Tensor, layer: int, width: int, threshold: int) -> torch.Tensor:
    parts = [
        dropout_bits(seed, slots[i : i + _BITS_CHUNK], layer, width) >= threshold
        for i in range(0, slots.shape[0], _BITS_CHUNK)
    ]
    return torch.cat(parts) if parts else torch.zeros(0, width, dtype=torch.bool, device=slots.device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _lab_base_max(num_l: int, lab_block_rows: int) -> int:
    labs_pad = max(-(-num_l // _LAB_PAD) * _LAB_PAD, lab_block_rows)
    return labs_pad - lab_block_rows


def _layer1_plain(
    proj_p, proj_l, w1, b1, lab_idx, win_local, win_tile_map, seed,
    tile_mask, lab_block_map, rate: float, lab_block_rows: int,
):
    """(active slots, their layer-1 pre-activations ``[n, H1]``, threshold,
    scale): the head up to its second ReLU."""
    num_p, num_l = proj_p.shape[0], proj_l.shape[0]
    active = win_local < WINDOW
    if tile_mask is not None:
        active = active & (torch.repeat_interleave(tile_mask, TILE_E) != 0)
    slots = torch.nonzero(active).squeeze(1)
    t = slots // TILE_E
    p = win_tile_map.long()[t] * WINDOW + win_local.long()[slots]
    l = lab_idx.long()[slots]
    lab_ok = (l >= 0) & (l < num_l)
    if lab_block_rows:
        base = lab_block_map.long()[t].clamp(0, _lab_base_max(num_l, lab_block_rows))
        lab_ok = lab_ok & (l >= base) & (l < base + lab_block_rows)
    zero = proj_p.new_zeros(())
    pp = torch.where((p < num_p)[:, None], proj_p[p.clamp_max(num_p - 1)], zero)
    pl = torch.where(lab_ok[:, None], proj_l[l.clamp(0, num_l - 1)], zero)
    h0 = torch.relu(pp + pl)
    threshold, scale = dropout_params(rate)
    if rate > 0:
        h0 = torch.where(_keep_mask(seed, slots, 0, h0.shape[1], threshold), h0 * scale, zero)
    return slots, h0 @ w1 + b1, threshold, scale


def pair_head_fwd_plain(
    proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
    tile_mask, lab_block_map, rate: float, lab_block_rows: int,
):
    """The head MLP on the gathered rows of every active slot (real, in an
    unmasked tile); every other slot outputs 0.  Differentiable."""
    slots, pre1, threshold, scale = _layer1_plain(
        proj_p, proj_l, w1, b1, lab_idx, win_local, win_tile_map, seed, tile_mask,
        lab_block_map, rate, lab_block_rows,
    )
    h1 = torch.relu(pre1)
    if rate > 0:
        keep = _keep_mask(seed, slots, 1, h1.shape[1], threshold)
        h1 = torch.where(keep, h1 * scale, proj_p.new_zeros(()))
    out = proj_p.new_zeros(win_local.shape[0])
    return out.index_put((slots,), h1 @ w2 + b2)


def relu_margin_plain(
    proj_p, proj_l, w1, b1, lab_idx, win_local, win_tile_map, seed,
    tile_mask, lab_block_map, rate: float, lab_block_rows: int,
) -> torch.Tensor:
    """``min_j |pre1[e, j]|`` per slot (0 for inactive slots): how far each
    slot's layer-1 pre-activations lie from the ReLU's kink.

    Kernel and plain version sum ``h0 @ W1`` in other orders, so a unit
    within that rounding of 0 may take the other side of the ReLU in each,
    and its slot's gradient then differs by a whole term.  A check of the
    backward gives such slots no upstream gradient.  (Layer 0 has no such
    case: ``proj_p[p] + proj_l[l]`` is one f32 add in both.)"""
    with torch.no_grad():
        slots, pre1, _, _ = _layer1_plain(
            proj_p, proj_l, w1, b1, lab_idx, win_local, win_tile_map, seed, tile_mask,
            lab_block_map, rate, lab_block_rows,
        )
        out = proj_p.new_zeros(win_local.shape[0])
        return out.index_put((slots,), pre1.abs().amin(dim=1))


def pair_head_bwd_plain(
    proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
    tile_mask, lab_block_map, rate: float, lab_block_rows: int, g_out,
):
    """Gradients of ``sum(pair_head_fwd_plain(...) * g_out)`` with respect
    to (proj_p, proj_l, w1, b1, w2, b2)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (proj_p, proj_l, w1, b1, w2, b2)]
        out = pair_head_fwd_plain(
            *leaves, lab_idx, win_local, win_tile_map, seed, tile_mask, lab_block_map,
            rate, lab_block_rows,
        )
        grads = torch.autograd.grad(out, leaves, g_out, allow_unused=True)
    return tuple(torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_head(name, proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map,
                tile_mask, lab_block_map, lab_block_rows) -> int:
    for x in (proj_p, proj_l, w1, b1, w2, b2):
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != proj_p.device:
            raise ValueError(f"{name}: head operands must be contiguous float32 on one device")
    if proj_p.dim() != 2 or proj_p.shape[1] != H0 or proj_l.dim() != 2 or proj_l.shape[1] != H0:
        raise ValueError(f"{name}: node projections must be [rows, {H0}]")
    if tuple(w1.shape) != (H0, H1) or b1.numel() != H1 or w2.numel() != H1 or b2.numel() != 1:
        raise ValueError(f"{name}: the kernels run the ({H0}, {H1}) head only")
    if proj_l.shape[0] == 0:
        raise ValueError(f"{name}: empty lab table")
    slots = win_local.shape[0]
    pairs = [(lab_idx, slots), (win_local, slots), (win_tile_map, slots // TILE_E)]
    if tile_mask is not None:
        pairs.append((tile_mask, slots // TILE_E))
    if lab_block_rows:
        pairs.append((lab_block_map, slots // TILE_E))
    return _check_plan(name, proj_p.device, slots, *pairs)


def _head_args(proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
               tile_mask, lab_block_map, rate, lab_block_rows, num_tiles):
    threshold, scale = dropout_params(rate)
    return (
        _ptr(proj_p), proj_p.shape[0], _ptr(proj_l), proj_l.shape[0], _ptr(w1), _ptr(b1),
        _ptr(w2), _ptr(b2), _ptr(lab_idx), _ptr(win_local), _ptr(win_tile_map), _ptr(tile_mask),
        _ptr(lab_block_map if lab_block_rows else None), int(lab_block_rows),
        _lab_base_max(proj_l.shape[0], lab_block_rows), num_tiles,
        int(seed[0]) & _M32, int(seed[1]) & _M32, threshold, scale, int(rate > 0),
    )


def pair_head_fwd(
    proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
    tile_mask: Optional[torch.Tensor], lab_block_map: Optional[torch.Tensor],
    rate: float, lab_block_rows: int,
) -> torch.Tensor:
    """K4f: the head's output per slot, ``[E_win]`` float32."""
    name = "pair_head_fwd"
    args = (proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
            tile_mask, lab_block_map, rate, lab_block_rows)
    if _on_cpu(proj_p, proj_l, w1, lab_idx, win_local, win_tile_map, tile_mask, lab_block_map):
        return pair_head_fwd_plain(*args)
    num_tiles = _check_head(name, proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local,
                            win_tile_map, tile_mask, lab_block_map, lab_block_rows)
    out = torch.empty(win_local.shape[0], dtype=torch.float32, device=proj_p.device)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_pair_head_fwd(
        *_head_args(*args, num_tiles), _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(proj_p.device).cuda_stream),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return out


def pair_head_bwd(
    proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
    tile_mask: Optional[torch.Tensor], lab_block_map: Optional[torch.Tensor],
    rate: float, lab_block_rows: int, num_windows: int, g_out: torch.Tensor,
):
    """K4b: (d_proj_p, d_proj_l, d_w1, d_b1, d_w2, d_b2) of
    ``sum(pair_head_fwd(...) * g_out)``; the forward is recomputed."""
    name = "pair_head_bwd"
    args = (proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
            tile_mask, lab_block_map, rate, lab_block_rows)
    if _on_cpu(proj_p, proj_l, w1, lab_idx, win_local, win_tile_map, tile_mask, lab_block_map, g_out):
        return pair_head_bwd_plain(*args, g_out)
    num_tiles = _check_head(name, proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local,
                            win_tile_map, tile_mask, lab_block_map, lab_block_rows)
    if g_out.dtype != torch.float32 or not g_out.is_contiguous() or g_out.shape != win_local.shape:
        raise ValueError(f"{name}: g_out must be contiguous float32 [E_win]")
    from multi_modal_gnn_tpu_torch.ops import _build

    lib = _build.load()
    num_l = proj_l.shape[0]
    need = lib.mmgnn_pair_head_bwd_shared_bytes(num_l)
    if need > _MAX_SHARED_BYTES:
        raise ValueError(
            f"{name}: a {num_l}-row lab table needs {need} B of shared memory, "
            f"the block limit is {_MAX_SHARED_BYTES}"
        )
    dev = proj_p.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles_per_block = max(1, -(-num_tiles // (sms * _BWD_BLOCKS_PER_SM)))
    zeros = lambda *shape: torch.zeros(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    dpp, dpl = zeros(max(num_windows * WINDOW, proj_p.shape[0]), H0), zeros(num_l, H0)
    dw1, db1, dw2, db2 = zeros(H0, H1), zeros(H1), zeros(H1), zeros(1)
    rc = lib.mmgnn_pair_head_bwd(
        *_head_args(*args, num_tiles), _ptr(g_out), tiles_per_block, _ptr(dpp), _ptr(dpl),
        _ptr(dw1), _ptr(db1), _ptr(dw2), _ptr(db2),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return dpp[: proj_p.shape[0]], dpl, dw1, db1.view_as(b1), dw2.view_as(w2), db2.view_as(b2)
