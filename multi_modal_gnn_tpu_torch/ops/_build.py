"""Build and load the CUDA segment kernels (``csrc/segment.cu``).

At first use ``nvcc`` compiles the source in this checkout into a shared
library with a plain C interface under ``multi_modal_gnn_tpu_torch/_build/``
(named by the source's hash, so an edited source builds anew), and ctypes
loads it.  A missing ``nvcc`` or a failed build raises; there is no other
path to the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "segment.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (register and shared-memory report) of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build() -> Path:
    """Compile ``csrc/segment.cu`` unless a library of this source exists."""
    global build_log
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libmmgnn_segment_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=600,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {SOURCE}:\n{build_log}")
    tmp.replace(out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mmgnn_segment_sum_windowed.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.mmgnn_fused_table_segment_sum.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.mmgnn_span_segment_sum.argtypes = [p, i, p, p, p, p, i, i, i, i, p, p]
    for fn in (
        lib.mmgnn_segment_sum_windowed,
        lib.mmgnn_fused_table_segment_sum,
        lib.mmgnn_span_segment_sum,
    ):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
