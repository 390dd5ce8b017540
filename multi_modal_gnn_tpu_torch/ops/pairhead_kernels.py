"""Fused pair-head kernels (CUDA, ``csrc/pairhead.cu``): wrappers and their
plain PyTorch versions.

==================  ============================================================
wrapper             replaces (``multi_modal_gnn_tpu/ops/pallas_pairhead.py``)
==================  ============================================================
pair_head_fwd       K4f ``_fused_fwd`` / ``_fwd_kernel``
pair_head_bwd       K4b ``_fused_bwd`` / ``_bwd_kernel``
pair_head_dual_fwd  K5f ``_dual_fused_fwd`` / ``_dual_fwd_kernel``
pair_head_dual_bwd  K5b ``_dual_fused_bwd`` / ``_dual_bwd_kernel``
==================  ============================================================

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; any other device raises.  The plain
forward is the head MLP written out on gathered rows; the plain backward is
autograd through it.  Both draw dropout from :func:`dropout_bits`, the
counter-based generator the kernels compute, so kernel and plain version
agree with dropout on.

The node projections and ``w1`` are float32 or bfloat16 (the model's compute
dtype), with ``b1``, ``w2`` and ``b2`` float32, as the TPU kernels take them.
With bfloat16 operands both the kernels and the plain versions round where
the TPU kernel rounds (``pallas_pairhead.py:102``, ``:124-141``): ``h0``
before ``h0 @ W1``, ``dpre1`` before both of its products and ``dpre0``
before its scatter, every sum in float32; the output is float32 and the
gradients come back in their operands' dtypes.  A bfloat16 call launches
the ``_bf16`` instantiation and counts under ``<name>_bf16``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW
from multi_modal_gnn_tpu_torch.ops.segment_kernels import _check_plan, _on_cpu, _ptr, _raise_on, _sms

launch_counts: Dict[str, int] = {
    f"{n}{sfx}": 0
    for n in ("pair_head_fwd", "pair_head_bwd", "pair_head_dual_fwd", "pair_head_dual_bwd")
    for sfx in ("", "_bf16")
}

H0, H1 = 64, 32  # the head widths the kernels are compiled for
# The dual head's one dropout stream numbers 2 * H0 columns per layer (the
# tabular head first), so no column of layer 0 shares a counter with one of
# layer 1.  The single head's stream numbers 64 columns per layer.
DUAL_LAYER_STRIDE = 2 * H0
# Dropout column layouts, as the kernels' SingleCols / TabCols / GnnCols:
# (counters per layer, first column of layer 0, first column of layer 1).
SINGLE_COLS = (H0, 0, 0)
DUAL_COLS = ((DUAL_LAYER_STRIDE, 0, 0), (DUAL_LAYER_STRIDE, H0, H1))  # tabular, GNN
_LAB_PAD = 128
_MAX_SHARED_BYTES = 232_448
# K4b / K5b (csrc/pairhead.cu): blocks of 8 warps, one an SM (a thread holds
# ~200 registers); warps take units of 128 slots from a counter; the block's
# shared memory: W1's B fragments split hi / lo for both products (4 x 8 KB),
# b1 and w2, and per warp 16 staging rows of 72 and of 40 floats, the group's
# Pp and Pl rows (2 x 16 of 72 floats) and the unit's metadata (3 x 128)
BWD_WARPS = 8
BWD_UNIT = 128
_BWD_BLOCKS_PER_SM = 1
BWD_SHARED_BYTES = 4 * 8192 + 4 * 2 * H1 + 4 * BWD_WARPS * (16 * (3 * (H0 + 8) + (H1 + 8)) + 3 * BWD_UNIT)
# K4f / K5f (csrc/pairhead.cu): blocks of 8 warps, two an SM (<= 128
# registers a thread); warps take units of 128 slots, the first by index and
# the rest from a counter a head, which the launch's last block zeroes again
# (one buffer a stream, `_fwd_counters`); the block's shared memory: W1's B
# fragments split hi / lo for h0 @ W1 (2 x 8 KB), b1 and w2, and per warp the
# group's Pp and Pl rows (2 x 16 of 72 floats) and the unit's metadata (2 x 128)
FWD_WARPS = 8
FWD_UNIT = BWD_UNIT
_FWD_BLOCKS_PER_SM = 2
FWD_SHARED_BYTES = 2 * 8192 + 4 * 2 * H1 + 4 * FWD_WARPS * (2 * 16 * (H0 + 8) + 2 * FWD_UNIT)
_M32 = 0xFFFFFFFF
_BITS_CHUNK = 1 << 18  # slots per chunk of the plain version's bit draws
_FWD_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def head_widths_supported(hidden_dims: Sequence[int], output_dim: int = 1) -> bool:
    """Whether K4 / K5 run a head of these widths: they are compiled for the
    (64, 32) head with one output.  The heads ask this before they route to
    the fused kernels (``models/layers.py``, ``models/rgcn.py``)."""
    return tuple(int(x) for x in hidden_dims) == (H0, H1) and int(output_dim) == 1


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


def dropout_bits(
    seed: Sequence[int], slots: torch.Tensor, layer: int, width: int, stride: int = H0,
    offset: int = 0,
) -> torch.Tensor:
    """uint32 draws (as int64) for columns ``offset..offset+width-1`` of
    layer ``layer`` at global slots ``slots``: ``[len(slots), width]``.
    Column ``c`` of layer ``L`` hashes the counter ``stride * L + c + 1``."""
    seed0, seed1 = int(seed[0]) & _M32, int(seed[1]) & _M32
    key = _fmix32(seed0 ^ _fmix32((slots.long() & _M32) ^ _fmix32_int(seed1)))
    ctr = torch.tensor(
        [((layer * stride + offset + c + 1) * 0x9E3779B9) & _M32 for c in range(width)],
        dtype=torch.int64, device=slots.device,
    )
    return _fmix32(key[:, None] ^ ctr[None, :])


def dual_seed(seed4: Sequence[int]) -> Tuple[int, int]:
    """The dual head's one seed pair from both heads' ``(tab0, tab1, gnn0,
    gnn1)``, as ``_dual_seed`` combines them (``pallas_pairhead.py:553``)."""
    return (int(seed4[0]) ^ int(seed4[2])) & _M32, (int(seed4[1]) ^ int(seed4[3])) & _M32


def dropout_params(rate: float) -> Tuple[int, float]:
    """(threshold, scale): keep a draw when ``bits >= threshold`` (unsigned),
    scale kept values by ``1 / (1 - rate)`` (as float32)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    threshold = min(int(rate * (1 << 32)), (1 << 32) - 1)
    return threshold, float(np.float32(1.0) / np.float32(1.0 - rate))


def _keep_mask(
    seed, slots: torch.Tensor, layer: int, width: int, threshold: int, cols=SINGLE_COLS
) -> torch.Tensor:
    stride, offset = cols[0], cols[1 + layer]
    parts = [
        dropout_bits(seed, slots[i : i + _BITS_CHUNK], layer, width, stride, offset) >= threshold
        for i in range(0, slots.shape[0], _BITS_CHUNK)
    ]
    return torch.cat(parts) if parts else torch.zeros(0, width, dtype=torch.bool, device=slots.device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


class _RoundOperand(torch.autograd.Function):
    """``x`` rounded to ``dtype`` (kept in its own dtype) as a product's
    operand; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """The identity whose backward rounds the gradient to ``dtype`` (kept in
    its own dtype): where the TPU kernel casts a gradient to ``in_dt``."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def _lab_base_max(num_l: int, lab_block_rows: int) -> int:
    labs_pad = max(-(-num_l // _LAB_PAD) * _LAB_PAD, lab_block_rows)
    return labs_pad - lab_block_rows


def _layer1_plain(
    proj_p, proj_l, w1, b1, lab_idx, win_local, win_tile_map, seed,
    tile_mask, lab_block_map, rate: float, lab_block_rows: int, cols=SINGLE_COLS,
):
    """(active slots, their layer-1 pre-activations ``[n, H1]`` (float32),
    threshold, scale): the head up to its second ReLU.  bfloat16 operands
    are read exactly; ``h0`` is rounded to them before ``h0 @ W1``, and in
    the backward ``dpre1`` before its products and ``dpre0`` before its
    scatter."""
    in_dt = proj_p.dtype
    rounds = in_dt == torch.bfloat16
    ct = torch.promote_types(in_dt, torch.float32)  # float32 sums (float64 in checks)
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
    zero = torch.zeros((), dtype=ct, device=proj_p.device)
    pp = torch.where((p < num_p)[:, None], proj_p.to(ct)[p.clamp_max(num_p - 1)], zero)
    pl = torch.where(lab_ok[:, None], proj_l.to(ct)[l.clamp(0, num_l - 1)], zero)
    pre0 = pp + pl
    if rounds:
        pre0 = _RoundGrad.apply(pre0, in_dt)
    h0 = torch.relu(pre0)
    threshold, scale = dropout_params(rate)
    if rate > 0:
        h0 = torch.where(_keep_mask(seed, slots, 0, h0.shape[1], threshold, cols), h0 * scale, zero)
    if rounds:
        h0 = _RoundOperand.apply(h0, in_dt)
    prod = h0 @ w1.to(ct)
    if rounds:
        prod = _RoundGrad.apply(prod, in_dt)
    return slots, prod + b1, threshold, scale


def pair_head_fwd_plain(
    proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
    tile_mask, lab_block_map, rate: float, lab_block_rows: int, cols=SINGLE_COLS,
):
    """The head MLP on the gathered rows of every active slot (real, in an
    unmasked tile); every other slot outputs 0.  ``cols`` is the dropout
    column layout.  Differentiable."""
    slots, pre1, threshold, scale = _layer1_plain(
        proj_p, proj_l, w1, b1, lab_idx, win_local, win_tile_map, seed, tile_mask,
        lab_block_map, rate, lab_block_rows, cols,
    )
    h1 = torch.relu(pre1)
    if rate > 0:
        keep = _keep_mask(seed, slots, 1, h1.shape[1], threshold, cols)
        h1 = torch.where(keep, h1 * scale, pre1.new_zeros(()))
    out = pre1.new_zeros(win_local.shape[0])
    return out.index_put((slots,), h1 @ w2 + b2)


def relu_margin_plain(
    proj_p, proj_l, w1, b1, lab_idx, win_local, win_tile_map, seed,
    tile_mask, lab_block_map, rate: float, lab_block_rows: int, cols=SINGLE_COLS,
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
            lab_block_map, rate, lab_block_rows, cols,
        )
        out = pre1.new_zeros(win_local.shape[0])
        return out.index_put((slots,), pre1.abs().amin(dim=1))


def pair_head_bwd_plain(
    proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
    tile_mask, lab_block_map, rate: float, lab_block_rows: int, g_out, cols=SINGLE_COLS,
):
    """Gradients of ``sum(pair_head_fwd_plain(...) * g_out)`` with respect
    to (proj_p, proj_l, w1, b1, w2, b2), each in its operand's dtype."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (proj_p, proj_l, w1, b1, w2, b2)]
        out = pair_head_fwd_plain(
            *leaves, lab_idx, win_local, win_tile_map, seed, tile_mask, lab_block_map,
            rate, lab_block_rows, cols,
        )
        grads = torch.autograd.grad(out, leaves, g_out, allow_unused=True)
    return tuple(torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads))


def pair_head_dual_fwd_plain(
    proj_p_t, proj_l_t, w1_t, b1_t, w2_t, b2_t, proj_p_g, proj_l_g, w1_g, b1_g, w2_g, b2_g,
    lab_idx, win_local, win_tile_map, seed4, tab_mask, gnn_mask, rate: float,
):
    """``(out_tab, out_gnn)``: each head's MLP on the gathered rows of every
    real slot of a tile its own mask keeps, 0 elsewhere, with dropout drawn
    from one stream over both heads' columns.  Differentiable."""
    heads = ((proj_p_t, proj_l_t, w1_t, b1_t, w2_t, b2_t), (proj_p_g, proj_l_g, w1_g, b1_g, w2_g, b2_g))
    plan = (lab_idx, win_local, win_tile_map, dual_seed(seed4))
    return tuple(
        pair_head_fwd_plain(*head, *plan, mask, None, rate, 0, cols=cols)
        for head, mask, cols in zip(heads, (tab_mask, gnn_mask), DUAL_COLS)
    )


def relu_margin_dual_plain(
    proj_p_t, proj_l_t, w1_t, b1_t, proj_p_g, proj_l_g, w1_g, b1_g,
    lab_idx, win_local, win_tile_map, seed4, tab_mask, gnn_mask, rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per head, :func:`relu_margin_plain` of the dual head (0 where the head
    is inactive)."""
    heads = ((proj_p_t, proj_l_t, w1_t, b1_t), (proj_p_g, proj_l_g, w1_g, b1_g))
    plan = (lab_idx, win_local, win_tile_map, dual_seed(seed4))
    return tuple(
        relu_margin_plain(*head, *plan, mask, None, rate, 0, cols=cols)
        for head, mask, cols in zip(heads, (tab_mask, gnn_mask), DUAL_COLS)
    )


def pair_head_dual_bwd_plain(
    proj_p_t, proj_l_t, w1_t, b1_t, w2_t, b2_t, proj_p_g, proj_l_g, w1_g, b1_g, w2_g, b2_g,
    lab_idx, win_local, win_tile_map, seed4, tab_mask, gnn_mask, rate: float, g_out_t, g_out_g,
):
    """Gradients of ``sum(out_tab * g_out_t + out_gnn * g_out_g)`` with
    respect to both heads' (proj_p, proj_l, w1, b1, w2, b2)."""
    heads = ((proj_p_t, proj_l_t, w1_t, b1_t, w2_t, b2_t), (proj_p_g, proj_l_g, w1_g, b1_g, w2_g, b2_g))
    plan = (lab_idx, win_local, win_tile_map, dual_seed(seed4))
    return tuple(
        grad
        for head, mask, cols, g_out in zip(heads, (tab_mask, gnn_mask), DUAL_COLS, (g_out_t, g_out_g))
        for grad in pair_head_bwd_plain(*head, *plan, mask, None, rate, 0, g_out, cols=cols)
    )


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_head(name, proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map,
                tile_mask, lab_block_map, lab_block_rows) -> int:
    for x in (proj_p, proj_l, w1, b1, w2, b2):
        if not x.is_contiguous() or x.device != proj_p.device:
            raise ValueError(f"{name}: head operands must be contiguous on one device")
    if proj_p.dtype not in (torch.float32, torch.bfloat16) or any(
        x.dtype != proj_p.dtype for x in (proj_l, w1)
    ):
        raise ValueError(f"{name}: proj_p, proj_l and w1 must all be float32 or all bfloat16")
    if any(x.dtype != torch.float32 for x in (b1, w2, b2)):
        raise ValueError(f"{name}: b1, w2 and b2 must be float32")
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


@dataclass(frozen=True)
class HeadLaunch:
    """Launch shape of a pair-head kernel: ``blocks`` persistent blocks a
    head of ``threads`` threads, whose warps take ``units`` units of 128
    slots, the backward's all from one counter a head, the forward's first by
    index; ``shared_bytes`` of dynamic shared memory a block, whatever the
    lab table's size."""

    blocks: int
    threads: int
    units: int
    heads: int
    shared_bytes: int


def _head_launch(num_tiles: int, sms: int, heads: int, warps: int, unit: int, per_sm: int,
                 shared_bytes: int) -> HeadLaunch:
    units = num_tiles * (TILE_E // unit)
    blocks = max(1, min(sms * per_sm, -(-units // warps)))
    return HeadLaunch(blocks=blocks, threads=32 * warps, units=units, heads=heads, shared_bytes=shared_bytes)


@functools.lru_cache(maxsize=None)
def bwd_launch(num_tiles: int, sms: int, heads: int = 1) -> HeadLaunch:
    """Plan K4b (``heads=1``) or K5b (``heads=2``, grid ``(blocks, 2)``)
    over ``num_tiles`` tiles on ``sms`` SMs: one wave of one block an SM,
    no more blocks than the units keep busy."""
    return _head_launch(num_tiles, sms, heads, BWD_WARPS, BWD_UNIT, _BWD_BLOCKS_PER_SM, BWD_SHARED_BYTES)


@functools.lru_cache(maxsize=None)
def fwd_launch(num_tiles: int, sms: int, heads: int = 1) -> HeadLaunch:
    """Plan K4f (``heads=1``) or K5f (``heads=2``, grid ``(blocks, 2)``,
    the GNN head's blocks first, the tabular head's resident as they
    retire): two blocks an SM a head, no more blocks than the units keep
    busy."""
    return _head_launch(num_tiles, sms, heads, FWD_WARPS, FWD_UNIT, _FWD_BLOCKS_PER_SM, FWD_SHARED_BYTES)


def _head_entry(direction: str, name: str, proj_p: torch.Tensor):
    """The C entry point of wrapper ``name`` for the operands' dtype and the
    launch counter it adds to (``name`` or ``name_bf16``)."""
    key = name + ("_bf16" if proj_p.dtype == torch.bfloat16 else "")
    return getattr(_head_lib(direction), f"mmgnn_{key}"), key


@functools.lru_cache(maxsize=None)
def _head_lib(direction: str) -> ctypes.CDLL:
    """The kernel library, once its pair-head ``direction`` kernels' shared
    layout is checked to be the one the plan counts (and to fit)."""
    from multi_modal_gnn_tpu_torch.ops import _build

    lib = _build.load()
    need = getattr(lib, f"mmgnn_pair_head_{direction}_shared_bytes")()
    planned = FWD_SHARED_BYTES if direction == "fwd" else BWD_SHARED_BYTES
    if need != planned or need > _MAX_SHARED_BYTES:
        raise RuntimeError(
            f"pair head {direction}: the kernel's shared layout ({need} B) is not the planned {planned} B"
        )
    return lib


def _fwd_counters(dev: torch.device, stream: torch.cuda.Stream) -> torch.Tensor:
    """K4f / K5f's counters on ``stream`` (two heads' units, the blocks
    done): zeroed once here, and again by each launch's last block."""
    key = (dev.index, stream.cuda_stream)
    if key not in _FWD_COUNTERS:
        _FWD_COUNTERS[key] = torch.zeros(3, dtype=torch.int32, device=dev)
    return _FWD_COUNTERS[key]


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
    fn, key = _head_entry("fwd", name, proj_p)
    dev = proj_p.device
    launch = fwd_launch(num_tiles, _sms(dev))
    out = torch.empty(win_local.shape[0], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    rc = fn(
        *_head_args(*args, num_tiles), _ptr(_fwd_counters(dev, stream)), launch.blocks, _ptr(out),
        ctypes.c_void_p(stream.cuda_stream),
    )
    _raise_on(rc, key)
    launch_counts[key] += 1
    return out


def pair_head_bwd(
    proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
    tile_mask: Optional[torch.Tensor], lab_block_map: Optional[torch.Tensor],
    rate: float, lab_block_rows: int, num_windows: int, g_out: torch.Tensor,
):
    """K4b: (d_proj_p, d_proj_l, d_w1, d_b1, d_w2, d_b2) of
    ``sum(pair_head_fwd(...) * g_out)``, each in its operand's dtype (summed
    in float32); the forward is recomputed."""
    name = "pair_head_bwd"
    args = (proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local, win_tile_map, seed,
            tile_mask, lab_block_map, rate, lab_block_rows)
    if _on_cpu(proj_p, proj_l, w1, lab_idx, win_local, win_tile_map, tile_mask, lab_block_map, g_out):
        return pair_head_bwd_plain(*args, g_out)
    num_tiles = _check_head(name, proj_p, proj_l, w1, b1, w2, b2, lab_idx, win_local,
                            win_tile_map, tile_mask, lab_block_map, lab_block_rows)
    if g_out.dtype != torch.float32 or not g_out.is_contiguous() or g_out.shape != win_local.shape:
        raise ValueError(f"{name}: g_out must be contiguous float32 [E_win]")
    fn, key = _head_entry("bwd", name, proj_p)
    num_l = proj_l.shape[0]
    dev = proj_p.device
    launch = bwd_launch(num_tiles, _sms(dev))
    zeros = lambda *shape: torch.zeros(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    dpp, dpl = zeros(max(num_windows * WINDOW, proj_p.shape[0]), H0), zeros(num_l, H0)
    dw1, db1, dw2, db2 = zeros(H0, H1), zeros(H1), zeros(H1), zeros(1)
    work = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = fn(
        *_head_args(*args, num_tiles), _ptr(g_out), _ptr(work), launch.blocks, _ptr(dpp), _ptr(dpl),
        _ptr(dw1), _ptr(db1), _ptr(dw2), _ptr(db2),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _raise_on(rc, key)
    launch_counts[key] += 1
    return _as_operands((dpp[: proj_p.shape[0]], dpl, dw1, db1, dw2, db2), args[:6])


def _as_operands(grads, operands):
    """The kernels' float32 gradients in their operands' dtypes and shapes."""
    return tuple(g.view_as(x).to(x.dtype) for g, x in zip(grads, operands))


def _check_dual(name, heads, lab_idx, win_local, win_tile_map, tab_mask, gnn_mask) -> int:
    for head in heads:
        _check_head(name, *head, lab_idx, win_local, win_tile_map, None, None, 0)
    (pp_t, pl_t, *_), (pp_g, pl_g, *_) = heads
    if pp_t.shape != pp_g.shape or pl_t.shape != pl_g.shape or pp_t.device != pp_g.device:
        raise ValueError(f"{name}: both heads' node projections must share their shapes and device")
    slots = win_local.shape[0]
    pairs = [(m, slots // TILE_E) for m in (tab_mask, gnn_mask) if m is not None]
    return _check_plan(name, pp_t.device, slots, (win_local, slots), *pairs)


def _dual_args(heads, lab_idx, win_local, win_tile_map, seed4, tab_mask, gnn_mask, rate, num_tiles):
    threshold, scale = dropout_params(rate)
    seed = dual_seed(seed4)
    return (
        *(_ptr(x) for head in heads for x in head), heads[0][0].shape[0], heads[0][1].shape[0],
        _ptr(lab_idx), _ptr(win_local), _ptr(win_tile_map), _ptr(tab_mask), _ptr(gnn_mask),
        num_tiles, seed[0], seed[1], threshold, scale, int(rate > 0),
    )


def pair_head_dual_fwd(
    proj_p_t, proj_l_t, w1_t, b1_t, w2_t, b2_t, proj_p_g, proj_l_g, w1_g, b1_g, w2_g, b2_g,
    lab_idx, win_local, win_tile_map, seed4,
    tab_mask: Optional[torch.Tensor], gnn_mask: Optional[torch.Tensor], rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5f: ``(out_tab, out_gnn)``, each ``[E_win]`` float32."""
    name = "pair_head_dual_fwd"
    heads = ((proj_p_t, proj_l_t, w1_t, b1_t, w2_t, b2_t), (proj_p_g, proj_l_g, w1_g, b1_g, w2_g, b2_g))
    plan = (lab_idx, win_local, win_tile_map, seed4, tab_mask, gnn_mask)
    if _on_cpu(proj_p_t, proj_l_t, proj_p_g, proj_l_g, w1_t, w1_g, lab_idx, win_local, win_tile_map,
               tab_mask, gnn_mask):
        return pair_head_dual_fwd_plain(*heads[0], *heads[1], *plan, rate)
    num_tiles = _check_dual(name, heads, lab_idx, win_local, win_tile_map, tab_mask, gnn_mask)
    fn, key = _head_entry("fwd", name, proj_p_t)
    dev = proj_p_t.device
    launch = fwd_launch(num_tiles, _sms(dev), heads=2)
    out_t, out_g = (torch.empty(win_local.shape[0], dtype=torch.float32, device=dev) for _ in range(2))
    stream = torch.cuda.current_stream(dev)
    rc = fn(
        *_dual_args(heads, *plan, rate, num_tiles), _ptr(_fwd_counters(dev, stream)), launch.blocks,
        _ptr(out_t), _ptr(out_g), ctypes.c_void_p(stream.cuda_stream),
    )
    _raise_on(rc, key)
    launch_counts[key] += 1
    return out_t, out_g


def pair_head_dual_bwd(
    proj_p_t, proj_l_t, w1_t, b1_t, w2_t, b2_t, proj_p_g, proj_l_g, w1_g, b1_g, w2_g, b2_g,
    lab_idx, win_local, win_tile_map, seed4,
    tab_mask: Optional[torch.Tensor], gnn_mask: Optional[torch.Tensor], rate: float,
    num_windows: int, g_out_t: torch.Tensor, g_out_g: torch.Tensor,
):
    """K5b: both heads' (d_proj_p, d_proj_l, d_w1, d_b1, d_w2, d_b2), the
    tabular head's first, of ``sum(out_tab * g_out_t + out_gnn * g_out_g)``,
    each in its operand's dtype; the forward is recomputed."""
    name = "pair_head_dual_bwd"
    heads = ((proj_p_t, proj_l_t, w1_t, b1_t, w2_t, b2_t), (proj_p_g, proj_l_g, w1_g, b1_g, w2_g, b2_g))
    plan = (lab_idx, win_local, win_tile_map, seed4, tab_mask, gnn_mask)
    if _on_cpu(proj_p_t, proj_l_t, proj_p_g, proj_l_g, w1_t, w1_g, lab_idx, win_local, win_tile_map,
               tab_mask, gnn_mask, g_out_t, g_out_g):
        return pair_head_dual_bwd_plain(*heads[0], *heads[1], *plan, rate, g_out_t, g_out_g)
    num_tiles = _check_dual(name, heads, lab_idx, win_local, win_tile_map, tab_mask, gnn_mask)
    for g in (g_out_t, g_out_g):
        if g.dtype != torch.float32 or not g.is_contiguous() or g.shape != win_local.shape:
            raise ValueError(f"{name}: g_out must be contiguous float32 [E_win]")
    fn, key = _head_entry("bwd", name, proj_p_t)
    num_p, num_l = proj_p_t.shape[0], proj_l_t.shape[0]
    dev = proj_p_t.device
    launch = bwd_launch(num_tiles, _sms(dev), heads=2)
    zeros = lambda *shape: torch.zeros(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    grads = [
        [zeros(max(num_windows * WINDOW, num_p), H0), zeros(num_l, H0), zeros(H0, H1), zeros(H1),
         zeros(H1), zeros(1)]
        for _ in heads
    ]
    work = torch.zeros(2, dtype=torch.int32, device=dev)
    rc = fn(
        *_dual_args(heads, *plan, rate, num_tiles), _ptr(g_out_t), _ptr(g_out_g), _ptr(work),
        launch.blocks, *(_ptr(x) for head_grads in grads for x in head_grads),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _raise_on(rc, key)
    launch_counts[key] += 1
    out = ()
    for head, (dpp, *rest) in zip(heads, grads):
        out += _as_operands((dpp[:num_p], *rest), head)
    return out
