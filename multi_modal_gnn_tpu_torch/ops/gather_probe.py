"""P1, the in-kernel row-gather probe (CUDA, ``csrc/gather_probe.cu``):
wrappers and their plain PyTorch versions.

``scripts/bench_gather_impl.py`` asks how the pair head should gather its
lab rows inside a kernel, at the head's shapes: 1024-slot tiles of int32
indices into a ``[rows, H]`` float32 or bfloat16 table (its ``--dtype``),
each slot's row reduced to its float32 sum.

======================  =======================================================
wrapper                 replaces (``scripts/bench_gather_impl.py`` ``build``)
======================  =======================================================
gather_probe_indicator  A, ``_kernel_indicator``: one-hot matrix times the table
gather_probe_padded     B, ``_kernel_dyngather`` on a 128-wide zero-padded table
gather_probe_direct     C, ``_kernel_dyngather`` on the table at its own width
======================  =======================================================

Every variant computes ``out[e] = sum_{c < h} table[idx[e], c]`` in
float32 over ``[num_tiles * 1024]`` slots, an index outside ``[0, rows)``
reading a zero row; :func:`gather_rowsum_plain` is the plain version of all
three.  A bfloat16 table runs each variant's bfloat16 kernel (A on the bf16
tensor cores, the script's ``preferred_element_type=f32`` product; B and C
widen each gathered value to float32 before the sum, as its
``astype(jnp.float32)``), counted under ``<name>_bf16``.  Each wrapper takes
the plain version for tensors on the CPU and launches its kernel for tensors
on a CUDA device; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from multi_modal_gnn_tpu_torch.ops.segment_kernels import _check_plan, _on_cpu, _ptr, _raise_on

WRAPPERS = ("gather_probe_indicator", "gather_probe_padded", "gather_probe_direct")
launch_counts: Dict[str, int] = {key: 0 for name in WRAPPERS for key in (name, f"{name}_bf16")}

PADDED_WIDTH = 128  # variant B's table width (the TPU's lane count)
_MAX_STAGED_BYTES = 200 * 1024  # B / C stage a table up to this size in shared memory
_DIRECT_BLOCKS_PER_SM = 2  # B / C from L2: persistent blocks per SM
_SHARED_BYTES_PER_BLOCK = 227 * 1024  # the H100's most for one block


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def gather_rowsum_plain(idx: torch.Tensor, table: torch.Tensor, h: int) -> torch.Tensor:
    """``table[idx, :h]`` in float32, summed over each row; zero for an index
    outside the table."""
    rows = table.shape[0]
    ok = (idx >= 0) & (idx < rows)
    sums = table[idx.long().clamp(0, rows - 1), :h].float().sum(dim=1)
    return torch.where(ok, sums, sums.new_zeros(()))


def _suffix(table: torch.Tensor) -> str:
    return "_bf16" if table.dtype == torch.bfloat16 else ""


def direct_staged(rows: int, width: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether B / C stage a ``[rows, width]`` table of ``dtype`` in shared
    memory (else they read its rows through L1 / L2)."""
    from multi_modal_gnn_tpu_torch.ops import _build

    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    return getattr(_build.load(), f"mmgnn_gather_direct_staged_bytes{suffix}")(rows, width) <= _MAX_STAGED_BYTES


def _check(name: str, idx: torch.Tensor, table: torch.Tensor, h: int, h_multiple: int) -> int:
    if table.dtype not in (torch.float32, torch.bfloat16) or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{name}: the table must be a contiguous float32 or bfloat16 [rows, width] tensor")
    if table.shape[0] == 0 or table.shape[1] % 4 or table.data_ptr() % 16:
        raise ValueError(f"{name}: the table needs rows, a width that is a multiple of 4, 16-byte alignment")
    if not 0 < h <= table.shape[1] or h % h_multiple:
        raise ValueError(f"{name}: h={h} must be a multiple of {h_multiple} within the table's width")
    return _check_plan(name, table.device, idx.shape[0], (idx, idx.shape[0]))


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def gather_probe_indicator(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """A: per 1024-slot tile, the one-hot ``[1024, rows]`` matrix of its
    indices times the ``[rows, H]`` table, each product row summed.  A
    bfloat16 table runs on the tensor cores and must fit in one block's
    shared memory, transposed (``mmgnn_gather_indicator_bf16_shared_bytes``:
    133 KB at ``[512, 128]``)."""
    name = "gather_probe_indicator"
    if _on_cpu(idx, table):
        return gather_rowsum_plain(idx, table, table.shape[1])
    rows, h = table.shape
    bf16 = table.dtype == torch.bfloat16
    num_tiles = _check(name, idx, table, h, 8 if bf16 else 16)
    out = torch.empty(idx.shape[0], dtype=torch.float32, device=table.device)
    from multi_modal_gnn_tpu_torch.ops import _build

    lib = _build.load()
    if bf16:
        if lib.mmgnn_gather_indicator_bf16_shared_bytes(rows, h) > _SHARED_BYTES_PER_BLOCK:
            raise ValueError(f"{name}: a bfloat16 [{rows}, {h}] table does not fit in one block's shared memory")
        blocks = min(torch.cuda.get_device_properties(table.device).multi_processor_count, num_tiles)
        rc = lib.mmgnn_gather_indicator_bf16(
            _ptr(idx), _ptr(table), rows, h, num_tiles, blocks, _ptr(out), _stream(table)
        )
    else:
        rc = lib.mmgnn_gather_indicator(_ptr(idx), _ptr(table), rows, h, num_tiles, _ptr(out), _stream(table))
    _raise_on(rc, name)
    launch_counts[name + _suffix(table)] += 1
    return out


def _direct(name: str, idx: torch.Tensor, table: torch.Tensor, h: int) -> torch.Tensor:
    num_tiles = _check(name, idx, table, h, 4)
    rows, width = table.shape
    staged = direct_staged(rows, width, table.dtype)
    dev = table.device
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * (
        1 if staged else _DIRECT_BLOCKS_PER_SM
    )
    out = torch.empty(idx.shape[0], dtype=torch.float32, device=dev)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = getattr(_build.load(), "mmgnn_gather_direct" + _suffix(table))(
        _ptr(idx), _ptr(table), rows, width, h, num_tiles, min(blocks, num_tiles), int(staged),
        _ptr(out), _stream(table),
    )
    _raise_on(rc, name)
    launch_counts[name + _suffix(table)] += 1
    return out


def gather_probe_padded(idx: torch.Tensor, table: torch.Tensor, h: int) -> torch.Tensor:
    """B: each slot's row by index from a ``[rows, 128]`` table whose
    columns past ``h`` are zero, summed over its first ``h`` columns."""
    name = "gather_probe_padded"
    if table.dim() != 2 or table.shape[1] != PADDED_WIDTH:
        raise ValueError(f"{name}: the table must be [rows, {PADDED_WIDTH}]")
    if _on_cpu(idx, table):
        return gather_rowsum_plain(idx, table, h)
    return _direct(name, idx, table, h)


def gather_probe_direct(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """C: each slot's row by index from the ``[rows, H]`` table, summed."""
    name = "gather_probe_direct"
    if _on_cpu(idx, table):
        return gather_rowsum_plain(idx, table, table.shape[1])
    return _direct(name, idx, table, table.shape[1])
