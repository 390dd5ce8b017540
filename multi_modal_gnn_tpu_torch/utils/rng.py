"""Seeds of named random streams, as pure functions of (seed, name, index).

The JAX package derives per-epoch keys with ``jax.random.fold_in``
(``multi_modal_gnn_tpu/utils/rng.py``); the port derives the integers that
seed a ``torch.Generator`` or a kernel's counter-based generator the same
way, so an epoch's draws depend on nothing but the run's seed.  The two
packages draw different numbers from the same seed.
"""

from __future__ import annotations

import contextlib
import random
import zlib

import numpy as np
import torch


def stream_seed(seed: int, name: str, index: int = 0) -> int:
    """A 63-bit seed for draw ``index`` of stream ``name``."""
    state = np.random.SeedSequence([int(seed), zlib.crc32(name.encode()), int(index)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def fold_in(seed: int, index: int) -> int:
    """A seed for sub-stream ``index`` of the stream ``seed`` seeds (JAX
    ``jax.random.fold_in``)."""
    return stream_seed(seed, "fold_in", index)


def stream_seed_pair(seed: int, name: str, index: int = 0) -> tuple:
    """Two 32-bit words for a kernel's counter-based generator."""
    state = np.random.SeedSequence([int(seed), zlib.crc32(name.encode()), int(index)])
    words = state.generate_state(2, np.uint32)
    return int(words[0]), int(words[1])


def apply_reproducibility(config):
    """Apply ``config.reproducibility``: with ``set_seeds``, seed Python's
    and numpy's global generators (JAX ``set_global_seeds``); returns the
    context to train in: autograd's anomaly mode with its NaN check when
    ``debug_nans`` (JAX ``jax_debug_nans``), else a no-op.
    ``deterministic: true`` never gets here: the config refuses it."""
    rc = config.reproducibility
    if rc.set_seeds:
        random.seed(rc.random_seed)
        np.random.seed(rc.numpy_seed)
    if rc.debug_nans:
        return torch.autograd.detect_anomaly(check_nan=True)
    return contextlib.nullcontext()
