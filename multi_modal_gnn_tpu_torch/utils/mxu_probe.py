"""The tensor-core dtype probe behind ``model.compute_dtype: auto``
(``multi_modal_gnn_tpu/utils/mxu_probe.py``; the name is kept so a reader
finds it).

``auto`` probes the card once per device name: ``repeats`` interleaved
(float32, bfloat16) pairs of a chain of 32 dependent ``[2048, 2048]``
matmuls, each chain timed with CUDA events.  The float32 side runs as the
port runs float32 (TF32 off, :func:`~multi_modal_gnn_tpu_torch.utils.device.disable_tf32`),
the bfloat16 side with float32 sums.  Per pair ``r = t_f32 / t_bf16``;
bfloat16 engages only when the smallest ratio clears 1.15, JAX's rule.  On
the CPU ``auto`` is float32 without probing, and a probe that fails leaves
float32 with a warning, as in JAX.

Results are kept in-process and on disk per device name, in
``multi_modal_gnn_tpu_torch/_build/mxu_probe.json`` (git-ignored; the
repository root's ``.mxu_probe.json`` is the JAX package's).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict

import torch

from multi_modal_gnn_tpu_torch.utils.device import disable_tf32

logger = logging.getLogger(__name__)

CACHE_PATH = Path(__file__).resolve().parents[1] / "_build" / "mxu_probe.json"
BF16_ENGAGE_RATIO = 1.15
DEFAULT_REPEATS = 3
_memo: Dict[str, Dict] = {}


def _time_matmul(dtype: torch.dtype, iters: int = 7, chain: int = 32, dim: int = 2048) -> float:
    """Median seconds of ``chain`` dependent ``[dim, dim]`` matmuls on the
    card (``b = 1 / dim`` keeps the iterate near 1 in either dtype), timed
    with CUDA events after one warm-up chain."""
    dev = torch.device("cuda", torch.cuda.current_device())
    x0 = torch.ones(dim, dim, dtype=dtype, device=dev)
    b = torch.full((dim, dim), 1.0 / dim, dtype=dtype, device=dev)

    def step():
        x = x0
        for _ in range(chain):
            x = x @ b
        return x

    step()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    times.sort()
    return times[len(times) // 2]


def probe_bf16_stats(force: bool = False, repeats: int = DEFAULT_REPEATS) -> Dict:
    """``t_f32 / t_bf16`` on the card with its spread: ``{"ratio": median
    over the pairs, "ratio_min", "ratio_max", "repeats", "t_f32_ms",
    "t_bf16_ms"}`` (> 1: bfloat16 is faster).  Cached per device name
    unless ``force``; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the tensor-core probe needs a CUDA device")
    kind = torch.cuda.get_device_name(torch.cuda.current_device())
    if not force:
        if kind in _memo:
            return _memo[kind]
        try:
            entry = json.loads(CACHE_PATH.read_text()).get(kind)
        except (OSError, ValueError):
            entry = None
        if entry and "ratio_min" in entry:
            _memo[kind] = entry
            return entry
    disable_tf32()
    t_f32, t_bf16 = [], []
    for _ in range(max(int(repeats), 1)):  # interleaved: drift hits both sides of a pair
        t_f32.append(_time_matmul(torch.float32))
        t_bf16.append(_time_matmul(torch.bfloat16))
    ratios = sorted(f / b for f, b in zip(t_f32, t_bf16))
    entry = {
        "ratio": round(ratios[len(ratios) // 2], 4),
        "ratio_min": round(ratios[0], 4),
        "ratio_max": round(ratios[-1], 4),
        "repeats": len(ratios),
        "t_f32_ms": [round(1e3 * t, 4) for t in t_f32],
        "t_bf16_ms": [round(1e3 * t, 4) for t in t_bf16],
    }
    logger.info(
        "tensor-core probe (%s): ratio median %.3f [min %.3f, max %.3f] over %d pairs",
        kind, entry["ratio"], entry["ratio_min"], entry["ratio_max"], entry["repeats"],
    )
    _memo[kind] = entry
    try:
        try:
            disk = json.loads(CACHE_PATH.read_text())
        except (OSError, ValueError):
            disk = {}
        disk[kind] = entry
        CACHE_PATH.parent.mkdir(parents=True, exist_ok=True)
        CACHE_PATH.write_text(json.dumps(disk, indent=2))
    except OSError:
        pass
    return entry


def probe_bf16_speedup(force: bool = False) -> float:
    """The median ``t_f32 / t_bf16`` (:func:`probe_bf16_stats`)."""
    return float(probe_bf16_stats(force=force)["ratio"])


def resolve_compute_dtype(configured: str, device=None) -> str:
    """``model.compute_dtype`` as a dtype name.  ``float32`` and
    ``bfloat16`` pass through; ``auto`` is ``float32`` for a CPU ``device``
    (or without a card) without probing, else ``bfloat16`` exactly when every
    probe pair's ratio clears :data:`BF16_ENGAGE_RATIO`, and ``float32``
    with a warning if the probe fails."""
    if configured != "auto":
        return configured
    on_card = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    if not on_card:
        return "float32"
    try:
        stats = probe_bf16_stats()
    except Exception as exc:  # noqa: BLE001 - a failed probe leaves the safe default, as in JAX
        logger.warning("tensor-core probe failed (%s); compute_dtype=float32", exc)
        return "float32"
    choice = "bfloat16" if stats["ratio_min"] >= BF16_ENGAGE_RATIO else "float32"
    logger.info(
        "compute_dtype=auto -> %s (bf16 speedup %.2f [%.2f, %.2f])",
        choice, stats["ratio"], stats["ratio_min"], stats["ratio_max"],
    )
    return choice
