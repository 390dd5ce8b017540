"""Windowed segment-sum kernels (CUDA, ``csrc/segment.cu``): wrappers and
their plain PyTorch versions.

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; any other device raises.  The forward
kernels return the f32 sum per window row, ``[num_windows * 128, D]``; the
caller slices ``[:num_dst]`` and divides by the in-degree for a mean.
K2b returns the small table's gradient ``[num_src, D]``.

============================  =================================================
wrapper                       replaces (``multi_modal_gnn_tpu/ops/pallas_segment.py``)
============================  =================================================
segment_sum_windowed          K1  ``_windowed_segment_sum_fwd`` / ``_segment_kernel``
fused_table_segment_sum       K2f ``_fused_table_segment_sum_fwd`` / ``_fused_table_kernel_take``
fused_table_segment_sum_bwd   K2b ``_fused_table_segment_sum_bwd`` / ``_fused_table_bwd_kernel_take``
span_segment_sum              K3  ``_span_dma_segment_sum_fwd`` / ``_span_dma_kernel``
============================  =================================================

K1 is also the backward of the span and paired tiers and of a planned row
gather (``ops/segment.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW

# launches per wrapper: each adds one where it launches its kernel
launch_counts: Dict[str, int] = {
    "segment_sum_windowed": 0,
    "fused_table_segment_sum": 0,
    "fused_table_segment_sum_bwd": 0,
    "span_segment_sum": 0,
}

_MAX_SHARED_BYTES = 232_448  # dynamic shared memory one H100 block may use
_BLOCKS_PER_SM_TARGET = 8
# K2b: shared bytes of one block's column slice of dT (at most 100 KB, so
# two or more blocks share an SM), and the blocks per SM the grid aims at
_K2B_SHARED_BUDGET = 100 * 1024
_K2B_BLOCKS_PER_SM = 4


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _window_rows(local: torch.Tensor, tile_map: torch.Tensor, num_windows: int) -> torch.Tensor:
    """Global output row of every slot; padding slots map to the dummy row
    ``num_windows * WINDOW``."""
    window_of_slot = torch.repeat_interleave(tile_map.long(), TILE_E)
    rows = window_of_slot * WINDOW + local.long()
    return torch.where(local < WINDOW, rows, torch.full_like(rows, num_windows * WINDOW))


def _scatter_rows(rows: torch.Tensor, gathered: torch.Tensor, num_windows: int) -> torch.Tensor:
    out = torch.zeros(
        num_windows * WINDOW + 1, gathered.shape[1], dtype=torch.float32, device=gathered.device
    )
    out.index_add_(0, rows, gathered.float())
    return out[: num_windows * WINDOW]


def segment_sum_windowed_plain(x, idx, win_local, win_tile_map, num_windows: int):
    gathered = x if idx is None else x.index_select(0, idx.long())
    return _scatter_rows(_window_rows(win_local, win_tile_map, num_windows), gathered, num_windows)


def fused_table_segment_sum_plain(table, win_src, win_local, win_tile_map, num_windows: int):
    return segment_sum_windowed_plain(table, win_src, win_local, win_tile_map, num_windows)


def fused_table_segment_sum_bwd_plain(g, win_src, win_local, win_tile_map, num_src: int):
    real = win_local < WINDOW
    window_of_slot = torch.repeat_interleave(win_tile_map.long(), TILE_E)[real]
    rows = window_of_slot * WINDOW + win_local[real].long()
    out = torch.zeros(num_src, g.shape[1], dtype=torch.float32, device=g.device)
    return out.index_add_(0, win_src[real].long(), g.float().index_select(0, rows))


def span_segment_sum_plain(
    table, span_src, span_local, span_tile_map, span_base, num_windows: int, span_rows: int
):
    # the span block only bounds where the kernel reads; the sum is the same
    return segment_sum_windowed_plain(table, span_src, span_local, span_tile_map, num_windows)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"segment kernels take tensors all on the CPU or all on one GPU, got {devices}")


def _check_rows(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 rows, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [rows, D] tensor, got {tuple(x.shape)}")
    if x.shape[1] % 4 or x.data_ptr() % 16:
        raise ValueError(f"{name}: D must be a multiple of 4 and rows 16-byte aligned")


def _check_plan(name: str, device, slots: int, *pairs) -> int:
    """Validate int32 plan arrays (pairs of (tensor, expected length));
    returns the tile count."""
    if slots % TILE_E or slots == 0:
        raise ValueError(f"{name}: slot count {slots} is not a positive multiple of {TILE_E}")
    for t, n in pairs:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: plan arrays must be contiguous 1-D int32")
        if t.shape[0] != n:
            raise ValueError(f"{name}: plan array of length {t.shape[0]}, expected {n}")
        if t.device != device:
            raise ValueError(f"{name}: plan array on {t.device}, rows on {device}")
    return slots // TILE_E


def _tiles_per_block(num_tiles: int, device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, -(-num_tiles // (sms * _BLOCKS_PER_SM_TARGET)))


# K3's static shared memory: the tile's slots sorted by row, and the counts
_SPAN_STATIC_SHARED_BYTES = 4 * (2 * TILE_E + WINDOW + 2)


def _check_shared(name: str, rows: int, d: int, static_bytes: int = 0) -> None:
    need = 4 * rows * d + static_bytes
    if need > _MAX_SHARED_BYTES:
        raise ValueError(f"{name}: needs {need} B of shared memory, the block limit is {_MAX_SHARED_BYTES}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def segment_sum_windowed(x, idx, win_local, win_tile_map, num_windows: int) -> torch.Tensor:
    """K1: ``out[tile_map[t]*128 + local[e]] += x[idx[e]]`` (or ``x[e]``
    with ``idx=None``, for rows already in slot order)."""
    name = "segment_sum_windowed"
    if _on_cpu(x, idx, win_local, win_tile_map):
        return segment_sum_windowed_plain(x, idx, win_local, win_tile_map, num_windows)
    _check_rows(x, name)
    slots = win_local.shape[0]
    pairs = [(win_local, slots), (win_tile_map, slots // TILE_E)]
    if idx is not None:
        pairs.append((idx, slots))
    elif x.shape[0] != slots:
        raise ValueError(f"{name}: {x.shape[0]} pre-gathered rows for {slots} slots")
    num_tiles = _check_plan(name, x.device, slots, *pairs)
    d = x.shape[1]
    _check_shared(name, WINDOW, d)
    out = torch.zeros(num_windows * WINDOW, d, dtype=torch.float32, device=x.device)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_segment_sum_windowed(
        _ptr(x), _ptr(idx), _ptr(win_local), _ptr(win_tile_map), num_tiles,
        _tiles_per_block(num_tiles, x.device), d, _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return out


def fused_table_segment_sum(table, win_src, win_local, win_tile_map, num_windows: int) -> torch.Tensor:
    """K2f: ``out[tile_map[t]*128 + local[e]] += table[win_src[e]]`` for a
    small source table."""
    name = "fused_table_segment_sum"
    if _on_cpu(table, win_src, win_local, win_tile_map):
        return fused_table_segment_sum_plain(table, win_src, win_local, win_tile_map, num_windows)
    _check_rows(table, name)
    slots = win_local.shape[0]
    num_tiles = _check_plan(
        name, table.device, slots, (win_src, slots), (win_local, slots),
        (win_tile_map, slots // TILE_E),
    )
    d = table.shape[1]
    _check_shared(name, WINDOW, d)
    out = torch.zeros(num_windows * WINDOW, d, dtype=torch.float32, device=table.device)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_fused_table_segment_sum(
        _ptr(table), _ptr(win_src), _ptr(win_local), _ptr(win_tile_map), num_tiles,
        _tiles_per_block(num_tiles, table.device), d, _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return out


def _k2b_columns(num_src: int, d: int) -> int:
    """Widest column slice (a power of two, 4..128, dividing d) whose
    ``[num_src, cols + 1]`` shared table fits the budget."""
    for cols in (128, 64, 32, 16, 8, 4):
        if d % cols == 0 and 4 * num_src * (cols + 1) <= _K2B_SHARED_BUDGET:
            return cols
    raise ValueError(
        f"fused_table_segment_sum_bwd: a {num_src}-row table does not fit a block's shared memory"
    )


def fused_table_segment_sum_bwd(g, win_src, win_local, win_tile_map, num_src: int) -> torch.Tensor:
    """K2b: ``dT[win_src[e]] += g[tile_map[t]*128 + local[e]]`` over the real
    slots: the gradient of K2f's small table, from the destination rows
    ``g [num_dst, D]``."""
    name = "fused_table_segment_sum_bwd"
    if _on_cpu(g, win_src, win_local, win_tile_map):
        return fused_table_segment_sum_bwd_plain(g, win_src, win_local, win_tile_map, num_src)
    _check_rows(g, name)
    slots = win_local.shape[0]
    num_tiles = _check_plan(
        name, g.device, slots, (win_src, slots), (win_local, slots),
        (win_tile_map, slots // TILE_E),
    )
    d = g.shape[1]
    cols = _k2b_columns(num_src, d)
    col_blocks = d // cols
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    tiles_per_block = max(1, -(-num_tiles * col_blocks // (sms * _K2B_BLOCKS_PER_SM)))
    out = torch.zeros(num_src, d, dtype=torch.float32, device=g.device)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_fused_table_segment_sum_bwd(
        _ptr(g), _ptr(win_src), _ptr(win_local), _ptr(win_tile_map), num_tiles,
        tiles_per_block, num_src, d, cols, _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(g.device).cuda_stream),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return out


def span_segment_sum(
    table, span_src, span_local, span_tile_map, span_base, num_windows: int, span_rows: int
) -> torch.Tensor:
    """K3: like K1 with ``idx=span_src``, but every tile reads its rows from
    one staged block ``table[span_base[t] : span_base[t] + span_rows]``.
    Rows past ``table.shape[0]`` are never read, so the table needs no
    padding."""
    name = "span_segment_sum"
    if _on_cpu(table, span_src, span_local, span_tile_map, span_base):
        return span_segment_sum_plain(
            table, span_src, span_local, span_tile_map, span_base, num_windows, span_rows
        )
    _check_rows(table, name)
    slots = span_local.shape[0]
    num_tiles = _check_plan(
        name, table.device, slots, (span_src, slots), (span_local, slots),
        (span_tile_map, slots // TILE_E), (span_base, slots // TILE_E),
    )
    d = table.shape[1]
    if span_rows <= 0:
        raise ValueError(f"{name}: span_rows must be positive, got {span_rows}")
    _check_shared(name, WINDOW + span_rows, d, _SPAN_STATIC_SHARED_BYTES)
    out = torch.zeros(num_windows * WINDOW, d, dtype=torch.float32, device=table.device)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_span_segment_sum(
        _ptr(table), table.shape[0], _ptr(span_src), _ptr(span_local), _ptr(span_tile_map),
        _ptr(span_base), num_tiles, _tiles_per_block(num_tiles, table.device), span_rows, d,
        _ptr(out), ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return out
