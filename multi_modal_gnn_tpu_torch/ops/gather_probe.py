"""P1, the in-kernel row-gather probe (CUDA, ``csrc/gather_probe.cu``):
wrappers and their plain PyTorch versions.

``scripts/bench_gather_impl.py`` asks how the pair head should gather its
lab rows inside a kernel, at the head's shapes: 1024-slot tiles of int32
indices into a ``[rows, H]`` f32 table, each slot's row reduced to its sum.

======================  =======================================================
wrapper                 replaces (``scripts/bench_gather_impl.py`` ``build``)
======================  =======================================================
gather_probe_indicator  A, ``_kernel_indicator``: one-hot matrix times the table
gather_probe_padded     B, ``_kernel_dyngather`` on a 128-wide zero-padded table
gather_probe_direct     C, ``_kernel_dyngather`` on the table at its own width
======================  =======================================================

Every variant computes ``out[e] = sum_{c < h} table[idx[e], c]`` over
``[num_tiles * 1024]`` slots, an index outside ``[0, rows)`` reading a zero
row; :func:`gather_rowsum_plain` is the plain version of all three.  Each
wrapper takes it for tensors on the CPU and launches its kernel for tensors
on a CUDA device; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from multi_modal_gnn_tpu_torch.ops.segment_kernels import _check_plan, _on_cpu, _ptr, _raise_on

launch_counts: Dict[str, int] = {
    "gather_probe_indicator": 0, "gather_probe_padded": 0, "gather_probe_direct": 0,
}

PADDED_WIDTH = 128  # variant B's table width (the TPU's lane count)
_MAX_STAGED_BYTES = 200 * 1024  # B / C stage a table up to this size in shared memory
_DIRECT_BLOCKS_PER_SM = 2  # B / C from L2: persistent blocks per SM


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def gather_rowsum_plain(idx: torch.Tensor, table: torch.Tensor, h: int) -> torch.Tensor:
    """``table[idx, :h].sum(1)``, zero for an index outside the table."""
    rows = table.shape[0]
    ok = (idx >= 0) & (idx < rows)
    sums = table[idx.long().clamp(0, rows - 1), :h].sum(dim=1)
    return torch.where(ok, sums, sums.new_zeros(()))


def direct_staged(rows: int, width: int) -> bool:
    """Whether B / C stage a ``[rows, width]`` table in shared memory (else
    they read its rows through L1 / L2)."""
    from multi_modal_gnn_tpu_torch.ops import _build

    return _build.load().mmgnn_gather_direct_staged_bytes(rows, width) <= _MAX_STAGED_BYTES


def _check(name: str, idx: torch.Tensor, table: torch.Tensor, h: int, h_multiple: int) -> int:
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{name}: the table must be a contiguous float32 [rows, width] tensor")
    if table.shape[0] == 0 or table.shape[1] % 4 or table.data_ptr() % 16:
        raise ValueError(f"{name}: the table needs rows, a width that is a multiple of 4, 16-byte alignment")
    if not 0 < h <= table.shape[1] or h % h_multiple:
        raise ValueError(f"{name}: h={h} must be a multiple of {h_multiple} within the table's width")
    return _check_plan(name, table.device, idx.shape[0], (idx, idx.shape[0]))


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def gather_probe_indicator(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """A: per 1024-slot tile, the one-hot ``[1024, rows]`` matrix of its
    indices times the ``[rows, H]`` table, each product row summed."""
    name = "gather_probe_indicator"
    if _on_cpu(idx, table):
        return gather_rowsum_plain(idx, table, table.shape[1])
    num_tiles = _check(name, idx, table, table.shape[1], 16)
    out = torch.empty(idx.shape[0], dtype=torch.float32, device=table.device)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_gather_indicator(
        _ptr(idx), _ptr(table), table.shape[0], table.shape[1], num_tiles, _ptr(out), _stream(table)
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
    return out


def _direct(name: str, idx: torch.Tensor, table: torch.Tensor, h: int) -> torch.Tensor:
    num_tiles = _check(name, idx, table, h, 4)
    rows, width = table.shape
    staged = direct_staged(rows, width)
    dev = table.device
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * (
        1 if staged else _DIRECT_BLOCKS_PER_SM
    )
    out = torch.empty(idx.shape[0], dtype=torch.float32, device=dev)
    from multi_modal_gnn_tpu_torch.ops import _build

    rc = _build.load().mmgnn_gather_direct(
        _ptr(idx), _ptr(table), rows, width, h, num_tiles, min(blocks, num_tiles), int(staged),
        _ptr(out), _stream(table),
    )
    _raise_on(rc, name)
    launch_counts[name] += 1
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
