"""P1 on the card: the in-kernel row gather, indicator product against
gather by index (``scripts/bench_gather_impl.py``, ported).

    python -m multi_modal_gnn_tpu_torch.tools.bench_gather [--tiles 3840] [--rows 512] [--h 64]

The flags and their defaults are the script's: ``--tiles`` 1024-slot tiles
of indices drawn uniformly over ``--rows`` table rows, an ``[rows, h]``
float32 table and its 128-wide zero-padded copy, all from
``np.random.default_rng(0)`` in the script's order.  It prints the
script's three lines (A indicator product, B gather from the padded table,
C gather at width ``h``), each time the median of CUDA-event-timed calls
of the kernel and the sum of its output to a scalar (whose 4 bytes are
read back once), then the card's name and power limit.  The port is
float32 only: ``--dtype bfloat16`` raises ``ConfigError``.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from multi_modal_gnn_tpu_torch.config import ConfigError
from multi_modal_gnn_tpu_torch.graph.hetero import TILE_E
from multi_modal_gnn_tpu_torch.ops import gather_probe as gp
from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, gpu_identity, require_cuda

TIMING_REPS = 20


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, default=3840)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)
    if args.dtype != "float32":
        raise ConfigError(f"--dtype {args.dtype}: the port's gather probe runs float32 only")
    if not 0 < args.h <= gp.PADDED_WIDTH or args.h % 16:
        raise ConfigError(f"--h {args.h}: a multiple of 16 up to {gp.PADDED_WIDTH}")
    if args.tiles <= 0 or args.rows <= 0:
        raise ConfigError("--tiles and --rows must be positive")
    return args


def make_inputs(args: argparse.Namespace):
    """(idx, table, padded table) as numpy arrays, drawn as the script draws them."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, args.rows, args.tiles * TILE_E, dtype=np.int32)
    table = rng.standard_normal((args.rows, args.h)).astype(np.float32)
    padded = rng.standard_normal((args.rows, gp.PADDED_WIDTH)).astype(np.float32)
    padded[:, : args.h] = table
    padded[:, args.h :] = 0.0
    return idx, table, padded


def _median_ms(fn, reps: int = TIMING_REPS) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Run the three variants on the card; returns ``{variant: {"ms", "sum"}}``."""
    args = parse_args(argv)
    dev = require_cuda()
    disable_tf32()
    idx, table, padded = (torch.from_numpy(a).to(dev) for a in make_inputs(args))
    variants = {
        "A": (lambda: gp.gather_probe_indicator(idx, table).sum(),
              f"A indicator matmul  [{args.rows},{args.h}]  "),
        "B": (lambda: gp.gather_probe_padded(idx, padded, args.h).sum(),
              f"B dyn gather 128-w  [{args.rows},128]->{args.h}"),
        "C": (lambda: gp.gather_probe_direct(idx, table).sum(),
              f"C dyn gather {args.h}-wide [{args.rows},{args.h}]  "),
    }
    results = {}
    for key, (fn, label) in variants.items():
        ms = _median_ms(fn)
        value = float(fn())  # the scalar's 4-byte read-back
        results[key] = {"ms": ms, "sum": value}
        print(f"{label}: {ms:8.3f} ms  sum={value:.1f}  (median of {TIMING_REPS} CUDA-event-timed calls)")
    va, vb = results["A"]["sum"], results["B"]["sum"]
    if abs(va - vb) / max(abs(va), 1.0) >= 1e-3:
        raise AssertionError(f"A and B disagree: {va} vs {vb}")
    print(gpu_identity())
    return results


if __name__ == "__main__":
    main()
