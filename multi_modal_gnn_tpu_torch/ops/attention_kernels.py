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

K6 runs as two CUDA kernels (the one pass over the tiles, then the merge of
its per-grab partials) and counts as one launch per call.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW
from multi_modal_gnn_tpu_torch.ops.segment_kernels import (
    _MAX_SHARED_BYTES,
    _check_plan,
    _check_rows,
    _check_shared,
    _check_slot_alignment,
    _on_cpu,
    _ptr,
    _raise_on,
    _sms,
)

# launches per wrapper: each adds one where it launches its kernel
launch_counts: Dict[str, int] = {
    "flash_attention_fwd": 0,
    "flash_attention_dq": 0,
    "flash_attention_dkv": 0,
}

EMPTY_LSE = 1e30  # the log-sum-exp of a row with no edges
EXP_CLAMP = 60.0  # the backward's bound on exp arguments
# K8 (csrc/attention.cu): the table route (flash_dkv_table_kernel) for a
# gathered side (q, dO) of at most as many rows as the attention plans keep
# in the resident, dst-sorted layout (graph/attn_plan.py
# ATTN_RESIDENT_MAX_ROWS), a column slice of whole heads of it staged in
# shared memory; otherwise the sort route (flash_dkv_kernel): persistent
# blocks over column slices that take tiles from a counter.  Both run 32
# warps a block, one block an SM.
DKV_TABLE_MAX_ROWS = 512
_DKV_WARPS = 32
_DKV_GRABS_PER_BLOCK = 16
_DKV_MAX_GRAB = 8
_DKT_UNIT = 64
_DKT_INDEX_BYTES = _DKV_WARPS * 2 * _DKT_UNIT * 4
_DKT_GRABS_PER_WARP = 4
_DKT_COUNTER_STRIDE = 32  # ints between two slices' counters: one 128-byte line each
# K6 and K7 (csrc/attention.cu flash_rows_kernel): persistent 32-warp blocks,
# one an SM, over column slices of whole heads take tiles from a counter per
# slice (K8's sort-route scheme), the widest slice that fits first; each
# slot reads its k | v row through L2.
_ROW_WARPS = 32
_ROW_GRABS_PER_BLOCK = 16
_ROW_MAX_GRAB = 8
# K6 writes a partial per block and window its grabs reach, which its merge
# reads back: a block's share in two grabs
_ROW_FWD_GRABS_PER_BLOCK = 2
_ROW_KINDS = ("fwd", "dq")

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


def _launch_args(name: str, device, src, local, tile_map) -> int:
    """The plan's tile count, its arrays checked."""
    slots = local.shape[0]
    return _check_plan(name, device, slots, (src, slots), (local, slots), (tile_map, slots // TILE_E))


@dataclass(frozen=True)
class DkvLaunch:
    """Launch shape of K8: grid ``(blocks, slices)``, each block on columns
    ``[c0, c0 + slice)`` (2^m whole heads), ``shared_bytes`` of dynamic
    shared memory a block.  ``route`` ``"table"``:
    a block stages that slice of q and dO at ``stride`` floats a row (and
    those heads' LSE and delta), its warps take ``grab`` units of 64 slots
    at a time.  ``"sort"``: persistent blocks take ``grab`` tiles at a time;
    a block holds the slice of the window's k | v rows and of its dk | dv
    partial, a cut run per row group, two staged tiles' slots and one sorted
    tile, the window's k | v rows of the slice too where ``stage_kv``."""

    route: str
    blocks: int
    grab: int
    slices: int
    slice: int
    stride: int
    shared_bytes: int
    stage_kv: bool = False

    @property
    def mode(self) -> int:
        """The kernel's mode argument: 0 table, 1 sort with k | v staged, 2 sort."""
        return 0 if self.route == "table" else 1 if self.stage_kv else 2


def _sort_shared_bytes(slice_: int, stage_kv: bool) -> int:
    groups = _DKV_WARPS * 32 // (slice_ // 4)
    return 4 * ((2 if stage_kv else 1) * WINDOW * 2 * slice_ + groups * 2 * slice_) + 4 * 6 * TILE_E


def _head_slices(h: int, num_heads: int):
    """Widths of 2^m whole heads, widest first, at most 128 columns."""
    dh = h // num_heads
    heads = num_heads & -num_heads  # the largest power of two dividing num_heads
    while heads >= 1:
        if heads * dh <= 128:
            yield heads * dh
        heads //= 2


@functools.lru_cache(maxsize=256)
def dkv_launch(num_tiles: int, num_rows: int, h: int, num_heads: int, sms: int) -> DkvLaunch:
    """Plan K8 over ``num_tiles`` tiles, gathering from ``num_rows`` rows of
    q / dO of width ``h`` in ``num_heads`` heads, on ``sms`` SMs, one block
    an SM for each column slice.  The table route when ``num_rows <=
    DKV_TABLE_MAX_ROWS`` and a slice of whole heads fits a block's shared
    memory (the widest that does; a slice narrower than 32 columns pads its
    rows by 4 floats, as K2f's), with K2f's grab size.  Otherwise the sort
    route at the widest slice whose window k | v rows fit beside its
    partial, else the narrowest slice with k and v read from device memory;
    each block takes about a sixteenth of its share of tiles at a time (1 to
    8)."""
    dh = h // num_heads
    widths = list(_head_slices(h, num_heads))
    if num_rows <= DKV_TABLE_MAX_ROWS:
        for width in widths:
            stride = width + (4 if width < 32 else 0)
            shared = 4 * (2 * num_rows * stride + 2 * num_rows * (width // dh)) + _DKT_INDEX_BYTES
            if shared <= _MAX_SHARED_BYTES:
                slices = h // width
                units = num_tiles * (TILE_E // _DKT_UNIT)
                blocks = max(1, min(-(-units // _DKV_WARPS), sms // slices))
                grab = max(1, -(-units // (blocks * _DKV_WARPS * _DKT_GRABS_PER_WARP)))
                return DkvLaunch(
                    route="table", blocks=blocks, grab=grab, slices=slices, slice=width,
                    stride=stride, shared_bytes=shared,
                )
    width = next((w for w in widths if _sort_shared_bytes(w, True) <= _MAX_SHARED_BYTES), None)
    stage_kv = width is not None
    width = width or widths[-1]
    slices = h // width
    blocks = max(1, min(num_tiles, sms // slices))
    grab = max(1, min(_DKV_MAX_GRAB, num_tiles // (blocks * _DKV_GRABS_PER_BLOCK)))
    return DkvLaunch(
        route="sort", blocks=blocks, grab=grab, slices=slices, slice=width, stride=0,
        shared_bytes=_sort_shared_bytes(width, stage_kv), stage_kv=stage_kv,
    )


@dataclass(frozen=True)
class RowsLaunch:
    """Launch shape of K6 or K7: grid ``(blocks, slices)``, each block on
    columns ``[c0, c0 + slice)`` (2^m whole heads), taking ``grab`` tiles at
    a time; ``shared_bytes`` of dynamic shared memory a block."""

    blocks: int
    grab: int
    slices: int
    slice: int
    shared_bytes: int


def _rows_edge_floats(kind: str, slice_: int) -> int:
    """Floats of a row group's cut run in ``flash_rows_kernel``
    (``csrc/attention.cu`` ``rows_edge_floats``): o (K6: then m and l a
    lane), a multiple of 4 so that each group's o is 16-byte aligned."""
    return slice_ + (slice_ // 2 + 3) // 4 * 4 if kind == "fwd" else slice_


def _rows_shared_bytes(kind: str, slice_: int) -> int:
    """Dynamic shared memory of ``flash_rows_kernel`` (``csrc/attention.cu``
    ``rows_shared_floats``): the window partial (K6: with a max and
    normaliser a lane), a cut run per row group, and two tiles' staged
    slots and one sorted."""
    quads = slice_ // 4
    groups = _ROW_WARPS * 32 // quads
    fwd = kind == "fwd"
    n = WINDOW * slice_
    n += 2 * WINDOW * quads if fwd else 0
    n += groups * _rows_edge_floats(kind, slice_)
    return 4 * n + 4 * 6 * TILE_E


def rows_launch_at(kind: str, num_tiles: int, h: int, sms: int, width: int) -> Optional[RowsLaunch]:
    """``kind``'s launch at column slices of ``width``, or None where that
    does not fit a block (:func:`rows_launch` picks among these; probes time
    them).  One block an SM for each slice; K7's blocks take about a
    sixteenth of their share of tiles at a time (1 to 8), K6's half (a
    block's stint in a window writes one partial, which the merge reads
    back)."""
    if kind not in _ROW_KINDS:
        raise ValueError(f"rows_launch: kind {kind!r} is not one of {_ROW_KINDS}")
    shared = _rows_shared_bytes(kind, width)
    if shared > _MAX_SHARED_BYTES:
        return None
    slices = h // width
    blocks = max(1, min(num_tiles, sms // slices))
    if kind == "fwd":
        grab = -(-num_tiles // (blocks * _ROW_FWD_GRABS_PER_BLOCK))
    else:
        grab = max(1, min(_ROW_MAX_GRAB, num_tiles // (blocks * _ROW_GRABS_PER_BLOCK)))
    return RowsLaunch(blocks=blocks, grab=grab, slices=slices, slice=width, shared_bytes=shared)


@functools.lru_cache(maxsize=256)
def rows_launch(kind: str, num_tiles: int, h: int, num_heads: int, sms: int) -> RowsLaunch:
    """Plan K6 (``kind`` ``"fwd"``) or K7 (``"dq"``) over ``num_tiles``
    tiles of width ``h`` in ``num_heads`` heads on ``sms`` SMs: the widest
    slice of whole heads that fits a block's shared memory
    (:func:`rows_launch_at`).  Width comes first: a tile's slots are staged
    and walked once a slice (``tools/attention_probe.py``, ``PERF.md`` §6)."""
    for width in _head_slices(h, num_heads):
        launch = rows_launch_at(kind, num_tiles, h, sms, width)
        if launch is not None:
            return launch
    raise ValueError(f"rows_launch: no slice of h={h} in {num_heads} heads fits a block")


def fwd_launch(num_tiles: int, h: int, num_heads: int, sms: int) -> RowsLaunch:
    """K6's plan (:func:`rows_launch`)."""
    return rows_launch("fwd", num_tiles, h, num_heads, sms)


def dq_launch(num_tiles: int, h: int, num_heads: int, sms: int) -> RowsLaunch:
    """K7's plan (:func:`rows_launch`)."""
    return rows_launch("dq", num_tiles, h, num_heads, sms)


def fwd_partial_entries(num_tiles: int, grab: int, num_windows: int) -> int:
    """Entries of K6's partial scratch, numbered ``grab index + window``: a
    block's stint in a window writes the entry of the grab where it met the
    window first, so every (grab, window) pair a grab's tiles reach has one
    at most."""
    return -(-num_tiles // grab) + num_windows


def _rows_plan(name: str, kind: str, q, src, local, tile_map, num_heads: int) -> RowsLaunch:
    """The plan's launch of a K6 / K7 call on CUDA tensors, its plan arrays
    checked."""
    num_tiles = _launch_args(name, q.device, src, local, tile_map)
    _check_slot_alignment(name, src, local)
    launch = rows_launch(kind, num_tiles, q.shape[1], num_heads, _sms(q.device))
    _check_shared(name, launch.shared_bytes)
    return launch


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
    launch = _rows_plan(name, "fwd", q, src, local, tile_map, num_heads)
    return _fwd_on(launch, q, k, v, src, local, tile_map, num_windows, num_heads)


def _fwd_on(launch: RowsLaunch, q, k, v, src, local, tile_map, num_windows: int,
            num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on checked CUDA tensors at ``launch`` (:func:`flash_attention_fwd`
    gives the plan's; probes and tests any of :func:`rows_launch_at`)."""
    name = "flash_attention_fwd"
    h, num_tiles = q.shape[1], local.shape[0] // TILE_E
    rows = num_windows * WINDOW
    entries = fwd_partial_entries(num_tiles, launch.grab, num_windows)
    f32 = dict(dtype=torch.float32, device=q.device)
    # the partials' maxima and sums (written before they are read), out and
    # lse (written whole); one zeroed allocation for the normalisers (an entry
    # no block writes keeps 0) and the counters (int32 0 has float32 0's bits)
    n = entries * WINDOW * num_heads
    scratch = torch.empty(n + entries * WINDOW * h, **f32)
    pm, po = scratch[:n], scratch[n:]
    zeroed = torch.zeros(n + _DKT_COUNTER_STRIDE * launch.slices, **f32)
    pl, work = zeroed[:n], zeroed[n:].view(torch.int32)
    out = torch.empty(rows, h, **f32)
    lse = torch.empty(rows, num_heads, **f32)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_flash_attention_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(src), _ptr(local), _ptr(tile_map), num_tiles, _ptr(work),
        launch.grab, launch.blocks, launch.slices, launch.slice, num_windows, h, num_heads, _ptr(pm),
        _ptr(pl), _ptr(po), _ptr(out), _ptr(lse), _stream(q.device),
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
    launch = _rows_plan(name, "dq", q, src, local, tile_map, num_heads)
    return _dq_on(launch, q, k, v, dout, lse, delta, src, local, tile_map, num_windows, num_heads)


def _dq_on(launch: RowsLaunch, q, k, v, dout, lse, delta, src, local, tile_map, num_windows: int,
           num_heads: int) -> torch.Tensor:
    """K7 on checked CUDA tensors at ``launch``, as :func:`_fwd_on`."""
    name = "flash_attention_dq"
    h = q.shape[1]
    # one zeroed allocation: dq, then the counters (int32 0 has float32 0's bits)
    n = num_windows * WINDOW * h
    buf = torch.zeros(n + _DKT_COUNTER_STRIDE * launch.slices, dtype=torch.float32, device=q.device)
    dq = buf[:n].view(-1, h)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_flash_attention_dq(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta), _ptr(src), _ptr(local),
        _ptr(tile_map), local.shape[0] // TILE_E, _ptr(buf[n:].view(torch.int32)), launch.grab,
        launch.blocks, launch.slices, launch.slice, h, num_heads, _ptr(dq), _stream(q.device),
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
    num_tiles = _launch_args(name, q.device, src, local, tile_map)
    _check_slot_alignment(name, src, local)
    launch = dkv_launch(num_tiles, q.shape[0], h, num_heads, _sms(q.device))
    _check_shared(name, launch.shared_bytes)
    # one zeroed allocation: dk, dv, then the counters (int32 0 has float32
    # 0's bits)
    n = num_windows * WINDOW * h
    buf = torch.zeros(2 * n + _DKT_COUNTER_STRIDE * launch.slices, dtype=torch.float32, device=q.device)
    dk, dv = buf[:n].view(-1, h), buf[n : 2 * n].view(-1, h)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_flash_attention_dkv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta), _ptr(src), _ptr(local),
        _ptr(tile_map), num_tiles, q.shape[0], k.shape[0], _ptr(buf[2 * n :].view(torch.int32)),
        launch.grab, launch.blocks, launch.mode, launch.slices, launch.slice,
        launch.stride, h, num_heads, _ptr(dk), _ptr(dv), _stream(q.device),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return dk, dv
