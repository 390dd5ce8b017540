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
gather, and the per-shard total of edge-sharded data parallelism, forward
and backward, where it adds its block into a row range of the global
buffer (``out=``; ``ops/segment.py``).

Rows are float32 or bfloat16 (the model's compute dtype), as the TPU kernels
take them; the sums and outputs are float32 either way.  A bfloat16 tensor
launches the kernel's bfloat16 instantiation (``mmgnn_<name>_bf16``) and
counts under ``<name>_bf16`` in :data:`launch_counts`; nothing is upcast to
run the float32 kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E, WINDOW

# launches per wrapper: each adds one where it launches its kernel
WRAPPERS = ("segment_sum_windowed", "fused_table_segment_sum", "fused_table_segment_sum_bwd",
             "span_segment_sum")
launch_counts: Dict[str, int] = {f"{n}{sfx}": 0 for n in WRAPPERS for sfx in ("", "_bf16")}

_MAX_SHARED_BYTES = 232_448  # dynamic shared memory one H100 block may use
_SM_SHARED_BYTES = 233_472  # shared memory of one H100 SM
# K2b and K3, the incidence products (csrc/segment.cu incidence_kernel):
# accumulator rows and columns of a block, rows of a staged slice, the most
# rows of a row block a unit may use, the resident blocks per SM the grid
# aims at (the kernel's registers allow two), and the tiles a block takes at
# a time
_MMA_ROWS = 128
_MMA_COLS = 128
_MMA_SLICE = 32
_MMA_MAX_K = 512
# the most span rows K3 takes; the span tier's dispatch routes taller spans
# to the paired tier (ops/segment.py span_dma_applicable)
SPAN_MAX_ROWS = _MMA_MAX_K
_MMA_BLOCKS_PER_SM = 2
_MMA_GRABS_PER_BLOCK = 16
_MMA_MAX_GRAB = 32
# K2f (csrc/segment.cu fused_table_kernel): 16 warps a block, one block an
# SM; warps take units of 64 slots; per warp 2 x 64 staged indices
_FT_WARPS = 16
_FT_UNIT = 64
_FT_INDEX_BYTES = _FT_WARPS * 2 * _FT_UNIT * 4
_FT_SLICES = (128, 64, 32, 16, 8, 4)  # bfloat16 rows: down to 8 (a 16-byte chunk)
_FT_GRABS_PER_WARP = 4  # the first by the warp's index, the rest from the counter
_FT_COUNTER_STRIDE = 32  # ints between two slices' counters: one 128-byte line each
# K1 (csrc/segment.cu): on a table of at most these rows and bytes (the
# fused-table tier's gates, ops/segment.py FUSED_TABLE_MAX_ROWS / _BYTES)
# K2f's kernel, the table staged in shared memory; otherwise
# gather_tile_kernel, a block a tile in 128-column slices
WINDOWED_TABLE_MAX_ROWS = 2048
WINDOWED_TABLE_MAX_BYTES = 4 * 1024 * 1024
_K1_SLICE = 128


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


def _check_rows(x: torch.Tensor, name: str, bf16: bool = False) -> None:
    """float32 rows with D a multiple of 4, or (``bf16``: the kernel has a
    bfloat16 instantiation) bfloat16 rows with D a multiple of 8 (rows of
    whole 16-byte chunks); either way contiguous and 16-byte aligned."""
    dtypes = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))} rows, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [rows, D] tensor, got {tuple(x.shape)}")
    per_chunk = 16 // x.element_size()
    if x.shape[1] % per_chunk or x.data_ptr() % 16:
        raise ValueError(f"{name}: D must be a multiple of {per_chunk} and rows 16-byte aligned")


def _entry(name: str, x: torch.Tensor):
    """The C entry point for ``x``'s row type and the launch counter it adds
    to: ``name`` for float32, ``name_bf16`` for bfloat16."""
    from multi_modal_gnn_tpu_torch.ops import _build

    key = name + ("_bf16" if x.dtype == torch.bfloat16 else "")
    return getattr(_build.load(), f"mmgnn_{key}"), key


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device) -> int:
    device = torch.device(device)
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


def _check_slot_alignment(name: str, *plan: torch.Tensor) -> None:
    """K2b / K3 read each thread's four slots with one 16-byte load."""
    if any(t.data_ptr() % 16 for t in plan):
        raise ValueError(f"{name}: slot arrays must be 16-byte aligned")


def _check_shared(name: str, need: int) -> None:
    if need > _MAX_SHARED_BYTES:
        raise ValueError(f"{name}: needs {need} B of shared memory, the block limit is {_MAX_SHARED_BYTES}")


@dataclass(frozen=True)
class IncidenceLaunch:
    """Launch shape and shared layout of K2b / K3 (``incidence_kernel``):
    grid ``(blocks, chunks, col_blocks)`` of persistent blocks that take
    ``grab`` tiles at a time from a counter per (chunk, column block);
    ``count_words`` 32-bit words per row of the ``[128, k]`` 16-bit count
    matrix, ``b_stride`` row elements per row of a staged 32-row slice (two
    buffers)."""

    blocks: int
    grab: int
    chunks: int
    col_blocks: int
    count_words: int
    b_stride: int
    shared_bytes: int


def incidence_launch(
    num_tiles: int, k_rows: int, chunks: int, d: int, sms: int, span: bool = False,
    itemsize: int = 4,
) -> IncidenceLaunch:
    """Plan K2b (``k_rows = 128``, ``chunks`` 128-source chunks) or K3
    (``span``: ``k_rows = span_rows``, one chunk, and 8 KB more shared memory
    for the next tile's slots) over ``num_tiles`` tiles of width
    ``d`` on ``sms`` SMs: one wave of blocks, each taking about a sixteenth of
    its share of tiles at a time (1 to 32), so the tiles' unequal work
    spreads over the blocks.

    A count row holds ``round8(k_rows) / 2 + 2`` words (2 mod 4, so the
    eight rows of an A fragment fall in distinct bank pairs); a slice row
    holds the block's columns rounded up to 8 and padded to 8 words mod 32
    (8 mod 32 floats, 8 mod 64 bfloat16 values of ``itemsize`` 2: the four
    rows of a B fragment fall in distinct banks)."""
    col_blocks = -(-d // _MMA_COLS)
    cols = -(-min(d, _MMA_COLS) // 8) * 8
    count_words = -(-k_rows // 8) * 4 + 2
    b_stride = cols + (8 - cols) % (128 // itemsize)
    shared = (
        4 * (_MMA_ROWS * count_words + (2 * TILE_E if span else 0))
        + itemsize * 2 * _MMA_SLICE * b_stride
    )
    per_sm = max(1, min(_MMA_BLOCKS_PER_SM, _SM_SHARED_BYTES // (shared + 1024)))
    blocks = max(1, min(num_tiles, sms * per_sm // (chunks * col_blocks)))
    grab = max(1, min(_MMA_MAX_GRAB, num_tiles // (blocks * _MMA_GRABS_PER_BLOCK)))
    return IncidenceLaunch(
        blocks=blocks, grab=grab, chunks=chunks, col_blocks=col_blocks, count_words=count_words,
        b_stride=b_stride, shared_bytes=shared,
    )


@dataclass(frozen=True)
class FusedTableLaunch:
    """Launch shape and shared layout of K2f (``fused_table_kernel``): grid
    ``(blocks, slices)``; a block keeps columns ``[c0, c0 + slice)`` of every
    table row in shared memory at ``stride`` elements a row, and its warps
    take ``grab`` units of 64 slots at a time, the first by their index and
    the rest from the slice's counter."""

    blocks: int
    slices: int
    slice: int
    stride: int
    grab: int
    units: int
    shared_bytes: int


@functools.lru_cache(maxsize=256)
def fused_table_launch(
    num_tiles: int, num_src: int, d: int, sms: int, itemsize: int = 4
) -> FusedTableLaunch:
    """Plan K2f over ``num_tiles`` tiles of a ``[num_src, d]`` table of
    ``itemsize``-byte values on ``sms`` SMs.  The slice is the widest of 128,
    64, ..., 4 columns (..., 8 for bfloat16: a 16-byte chunk) (at most ``d``)
    whose rows fit a block's shared memory beside the staged indices; rows
    of a slice narrower than 128 bytes are padded by 16 bytes, so the row
    groups of a quarter-warp read other banks.  The slices share the SMs,
    one block each, and a warp takes about a quarter of its share of units
    at a time: the counter's atomics serialize at one L2 slice, so a warp
    grabs a few times, not once a unit."""
    slices = [s for s in _FT_SLICES if s * itemsize >= 16]
    for s in slices:
        width = min(s, d)
        stride = width + (16 // itemsize if width * itemsize < 128 else 0)
        shared = itemsize * num_src * stride + _FT_INDEX_BYTES
        if shared <= _MAX_SHARED_BYTES or s == slices[-1]:
            break
    slices = -(-d // width)
    units = num_tiles * (TILE_E // _FT_UNIT)
    blocks = max(1, min(-(-units // _FT_WARPS), sms // slices))
    grab = max(1, -(-units // (blocks * _FT_WARPS * _FT_GRABS_PER_WARP)))
    return FusedTableLaunch(
        blocks=blocks, slices=slices, slice=width, stride=stride, grab=grab, units=units,
        shared_bytes=shared,
    )


def windowed_route(num_rows: int, d: int, gathered: bool = False, itemsize: int = 4) -> str:
    """K1's row source for ``x [num_rows, d]`` of ``itemsize``-byte values:
    ``"gathered"`` (rows already in slot order, ``idx=None``), ``"shared"``
    (a table within the fused-table tier's gates, staged in shared memory as
    K2f stages it) or ``"global"`` (a larger table, read from device
    memory)."""
    if gathered:
        return "gathered"
    small = num_rows <= WINDOWED_TABLE_MAX_ROWS and num_rows * d * itemsize <= WINDOWED_TABLE_MAX_BYTES
    return "shared" if small else "global"


@functools.lru_cache(maxsize=256)
def windowed_launch(
    num_tiles: int, num_rows: int, d: int, sms: int, route: str, itemsize: int = 4
) -> FusedTableLaunch:
    """Plan K1 over ``num_tiles`` tiles of rows ``[num_rows, d]`` on ``sms``
    SMs by its :func:`windowed_route`: the ``"shared"`` route is K2f's plan
    (:func:`fused_table_launch`); the others run a block a tile for each
    128-column slice (the grid's second dimension), with no shared memory
    of their own beyond the kernel's static 12-16 KB (``shared_bytes`` 0) and
    no counter (``grab`` 1, ``blocks`` the tiles)."""
    if route == "shared":
        return fused_table_launch(num_tiles, num_rows, d, sms, itemsize)
    if route not in ("global", "gathered"):
        raise ValueError(f"unknown K1 route {route!r}")
    width = min(_K1_SLICE, d)
    return FusedTableLaunch(
        blocks=num_tiles, slices=-(-d // width), slice=width, stride=width, grab=1,
        units=num_tiles * (TILE_E // _FT_UNIT), shared_bytes=0,
    )


def _zeroed_out_and_counters(rows: int, d: int, slices: int, device):
    """One zeroed allocation: the ``[rows, d]`` output, then the slices'
    unit counters (int32 0 has float32 0's bits)."""
    n = rows * d
    buf = torch.zeros(n + slices * _FT_COUNTER_STRIDE, dtype=torch.float32, device=device)
    return buf[:n].view(rows, d), buf[n:].view(torch.int32)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check_out(name: str, out: torch.Tensor, rows: int, d: int, device) -> None:
    if out.dtype != torch.float32 or tuple(out.shape) != (rows, d) or not out.is_contiguous():
        raise ValueError(f"{name}: out must be a contiguous float32 [{rows}, {d}] tensor, got {tuple(out.shape)}")
    if out.device != device or out.data_ptr() % 16:
        raise ValueError(f"{name}: out must lie on {device}, 16-byte aligned")


def segment_sum_windowed(
    x, idx, win_local, win_tile_map, num_windows: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K1: ``out[tile_map[t]*128 + local[e]] += x[idx[e]]`` (or ``x[e]``
    with ``idx=None``, for rows already in slot order); a source past
    ``x``'s rows adds nothing.

    ``out``: where to add the ``[num_windows * 128, D]`` float32 block (a
    contiguous row range of a larger zeroed buffer, as the per-shard total
    of data parallelism places its block, ``ops/segment.py``); the kernel's
    counters are then allocated apart.  Returns ``out``; without it a
    zeroed block of its own."""
    name = "segment_sum_windowed"
    if _on_cpu(x, idx, win_local, win_tile_map, out):
        block = segment_sum_windowed_plain(x, idx, win_local, win_tile_map, num_windows)
        return block if out is None else out.add_(block)
    _check_rows(x, name, bf16=True)
    slots = win_local.shape[0]
    pairs = [(win_local, slots), (win_tile_map, slots // TILE_E)]
    if idx is not None:
        pairs.append((idx, slots))
    elif x.shape[0] != slots:
        raise ValueError(f"{name}: {x.shape[0]} pre-gathered rows for {slots} slots")
    num_tiles = _check_plan(name, x.device, slots, *pairs)
    d = x.shape[1]
    route = windowed_route(x.shape[0], d, gathered=idx is None, itemsize=x.element_size())
    launch = windowed_launch(num_tiles, x.shape[0], d, _sms(x.device), route, x.element_size())
    _check_shared(name, launch.shared_bytes)
    if out is None:
        out, work = _zeroed_out_and_counters(num_windows * WINDOW, d, launch.slices, x.device)
    else:
        _check_out(name, out, num_windows * WINDOW, d, x.device)
        work = torch.zeros(launch.slices * _FT_COUNTER_STRIDE, dtype=torch.int32, device=x.device)
    fn, key = _entry(name, x)
    rc = fn(
        _ptr(x), x.shape[0], _ptr(idx), _ptr(win_local), _ptr(win_tile_map), num_tiles, _ptr(work),
        launch.grab, launch.blocks, launch.slices, launch.slice, launch.stride, int(route == "shared"),
        d, _ptr(out), ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _raise_on(rc, key)
    launch_counts[key] += 1
    return out


def fused_table_segment_sum(table, win_src, win_local, win_tile_map, num_windows: int) -> torch.Tensor:
    """K2f: ``out[tile_map[t]*128 + local[e]] += table[win_src[e]]`` for a
    small source table."""
    name = "fused_table_segment_sum"
    if _on_cpu(table, win_src, win_local, win_tile_map):
        return fused_table_segment_sum_plain(table, win_src, win_local, win_tile_map, num_windows)
    _check_rows(table, name, bf16=True)
    slots = win_local.shape[0]
    num_tiles = _check_plan(
        name, table.device, slots, (win_src, slots), (win_local, slots),
        (win_tile_map, slots // TILE_E),
    )
    d = table.shape[1]
    launch = fused_table_launch(num_tiles, table.shape[0], d, _sms(table.device), table.element_size())
    _check_shared(name, launch.shared_bytes)
    out, work = _zeroed_out_and_counters(num_windows * WINDOW, d, launch.slices, table.device)
    fn, key = _entry(name, table)
    rc = fn(
        _ptr(table), table.shape[0], _ptr(win_src), _ptr(win_local), _ptr(win_tile_map), num_tiles,
        _ptr(work), launch.grab, launch.blocks, launch.slices, launch.slice, launch.stride, d,
        _ptr(out), ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream),
    )
    _raise_on(rc, key)
    launch_counts[key] += 1
    return out


def fused_table_segment_sum_bwd(g, win_src, win_local, win_tile_map, num_src: int) -> torch.Tensor:
    """K2b: ``dT[win_src[e]] += g[tile_map[t]*128 + local[e]]`` over the real
    slots: the gradient of K2f's small table, from the destination rows
    ``g [num_dst, D]``."""
    name = "fused_table_segment_sum_bwd"
    if _on_cpu(g, win_src, win_local, win_tile_map):
        return fused_table_segment_sum_bwd_plain(g, win_src, win_local, win_tile_map, num_src)
    _check_rows(g, name, bf16=True)
    slots = win_local.shape[0]
    num_tiles = _check_plan(
        name, g.device, slots, (win_src, slots), (win_local, slots),
        (win_tile_map, slots // TILE_E),
    )
    _check_slot_alignment(name, win_src, win_local)
    d = g.shape[1]
    chunks = max(1, -(-num_src // _MMA_ROWS))
    launch = incidence_launch(num_tiles, WINDOW, chunks, d, _sms(g.device), itemsize=g.element_size())
    _check_shared(name, launch.shared_bytes)
    out = torch.zeros(num_src, d, dtype=torch.float32, device=g.device)
    work = torch.zeros(launch.chunks * launch.col_blocks, dtype=torch.int32, device=g.device)
    fn, key = _entry(name, g)
    rc = fn(
        _ptr(g), g.shape[0], _ptr(win_src), _ptr(win_local), _ptr(win_tile_map), num_tiles,
        _ptr(work), launch.grab, launch.blocks, launch.chunks, launch.col_blocks,
        launch.count_words, launch.b_stride, num_src, d, _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(g.device).cuda_stream),
    )
    _raise_on(rc, key)
    launch_counts[key] += 1
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
    _check_rows(table, name, bf16=True)
    slots = span_local.shape[0]
    num_tiles = _check_plan(
        name, table.device, slots, (span_src, slots), (span_local, slots),
        (span_tile_map, slots // TILE_E), (span_base, slots // TILE_E),
    )
    _check_slot_alignment(name, span_src, span_local)
    d = table.shape[1]
    if not 0 < span_rows <= _MMA_MAX_K:
        raise ValueError(f"{name}: span_rows must be in 1..{_MMA_MAX_K}, got {span_rows}")
    launch = incidence_launch(
        num_tiles, span_rows, 1, d, _sms(table.device), span=True, itemsize=table.element_size()
    )
    _check_shared(name, launch.shared_bytes)
    out = torch.zeros(num_windows * WINDOW, d, dtype=torch.float32, device=table.device)
    work = torch.zeros(launch.col_blocks, dtype=torch.int32, device=table.device)
    fn, key = _entry(name, table)
    rc = fn(
        _ptr(table), table.shape[0], _ptr(span_src), _ptr(span_local), _ptr(span_tile_map),
        _ptr(span_base), num_tiles, span_rows, _ptr(work), launch.grab, launch.blocks,
        launch.col_blocks, launch.count_words, launch.b_stride, d, _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream),
    )
    _raise_on(rc, key)
    launch_counts[key] += 1
    return out
