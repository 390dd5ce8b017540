"""Build and load the port's CUDA kernels (``csrc/*.cu``) and its host
graph core (``csrc/graphcore.cpp``).

At first use ``nvcc`` compiles every CUDA source in this checkout, one
process per source and all at once, and links the objects into one shared
library with a plain C interface under ``multi_modal_gnn_tpu_torch/_build/``
(named by the sources' hash, so an edited source builds anew); ctypes loads
it.  A missing ``nvcc`` or a failed build raises; there is no other path to
the kernels.

:func:`build_graphcore` compiles the graph core with the host's C++
compiler into the same directory, under a file lock: concurrent processes
(test workers, a phase's subprocess) wait for one build, which is written
under a temporary name and renamed into place.  It links zlib (``-lz``):
a host without zlib's header fails the build, with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# entry points with a bfloat16 twin of the same arguments (``<name>_bf16``)
_BF16_TWINS = (
    "mmgnn_segment_sum_windowed", "mmgnn_fused_table_segment_sum",
    "mmgnn_fused_table_segment_sum_bwd", "mmgnn_span_segment_sum", "mmgnn_pair_head_fwd",
    "mmgnn_pair_head_bwd", "mmgnn_pair_head_dual_fwd", "mmgnn_pair_head_dual_bwd",
    "mmgnn_gather_direct", "mmgnn_gather_direct_staged_bytes",
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


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library of these sources exists."""
    global build_log
    out = BUILD_DIR / f"libmmgnn_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objects: List[Path] = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objects)
    ]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        try:
            text, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += "\n(timed out)"
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = out.with_suffix(f".{tag}")
    try:
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objects)],
                capture_output=True, text=True, timeout=600,
            )
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
        tmp.replace(out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    head = [p, i, p, i, p, p, p, p, p, p, p, p, p, i, i, i, u, u, u, f, i]
    dual = [p] * 12 + [i, i, p, p, p, p, p, i, u, u, u, f, i]
    signatures = {
        "mmgnn_segment_sum_windowed": [p, i, p, p, p, i, p, *[i] * 7, p, p],
        "mmgnn_fused_table_segment_sum": [p, i, p, p, p, i, p, *[i] * 6, p, p],
        "mmgnn_fused_table_segment_sum_bwd": [p, i, p, p, p, i, p, *[i] * 8, p, p],
        "mmgnn_span_segment_sum": [p, i, p, p, p, p, i, i, p, *[i] * 6, p, p],
        "mmgnn_pair_head_fwd": [*head, p, i, p, p],
        "mmgnn_pair_head_fwd_shared_bytes": [],
        "mmgnn_pair_head_bwd": [*head, p, p, i, p, p, p, p, p, p, p],
        "mmgnn_pair_head_bwd_shared_bytes": [],
        "mmgnn_pair_head_dual_fwd": [*dual, p, i, p, p, p],
        "mmgnn_pair_head_dual_bwd": [*dual, p, p, p, i, *[p] * 12, p],
        "mmgnn_gather_indicator": [p, p, i, i, i, p, p],
        "mmgnn_gather_indicator_bf16": [p, p, i, i, i, i, p, p],
        "mmgnn_gather_indicator_bf16_shared_bytes": [i, i],
        "mmgnn_gather_direct": [p, p, i, i, i, i, i, i, p, p],
        "mmgnn_gather_direct_staged_bytes": [i, i],
        "mmgnn_flash_attention_fwd": [*[p] * 6, i, p, *[i] * 7, *[p] * 6],
        "mmgnn_flash_attention_dq": [*[p] * 9, i, p, *[i] * 6, p, p],
        "mmgnn_flash_attention_dkv": [*[p] * 9, i, i, i, p, *[i] * 8, p, p, p],
    }
    for name in _BF16_TWINS:
        signatures[f"{name}_bf16"] = signatures[name]
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


GRAPHCORE_SOURCE = _PKG / "csrc" / "graphcore.cpp"
GRAPHCORE_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
graphcore_log = ""  # the compiler's output of this process's graph-core build


def cxx() -> Optional[str]:
    """The host's C++ compiler (``$CXX``, ``g++``, ``c++``, ``clang++``), or
    None where there is none."""
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    return None


def build_graphcore() -> Path:
    """Compile ``csrc/graphcore.cpp`` unless a library of this source,
    compiler and machine exists; raises with the compiler's output when the
    build fails or no compiler is found."""
    global graphcore_log
    compiler = cxx()
    if compiler is None:
        raise RuntimeError("no C++ compiler found ($CXX, g++, c++, clang++) to build csrc/graphcore.cpp")
    h = hashlib.sha256(" ".join((compiler, platform.machine(), *GRAPHCORE_FLAGS)).encode())
    h.update(GRAPHCORE_SOURCE.read_bytes())
    out = BUILD_DIR / f"libgraphcore_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "graphcore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the process ends, too
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *GRAPHCORE_FLAGS, "-o", str(tmp), str(GRAPHCORE_SOURCE), "-lz"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            graphcore_log = f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            if proc.returncode != 0:
                raise RuntimeError(f"building csrc/graphcore.cpp failed:\n{graphcore_log}")
            tmp.replace(out)
        finally:
            tmp.unlink(missing_ok=True)
    return out
