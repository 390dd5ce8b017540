"""Seeds of named random streams, as pure functions of (seed, name, index).

The JAX package derives per-epoch keys with ``jax.random.fold_in``
(``multi_modal_gnn_tpu/utils/rng.py``); the port derives the integers that
seed a ``torch.Generator`` or a kernel's counter-based generator the same
way, so an epoch's draws depend on nothing but the run's seed.  The two
packages draw different numbers from the same seed.
"""

from __future__ import annotations

import zlib

import numpy as np


def stream_seed(seed: int, name: str, index: int = 0) -> int:
    """A 63-bit seed for draw ``index`` of stream ``name``."""
    state = np.random.SeedSequence([int(seed), zlib.crc32(name.encode()), int(index)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def stream_seed_pair(seed: int, name: str, index: int = 0) -> tuple:
    """Two 32-bit words for a kernel's counter-based generator."""
    state = np.random.SeedSequence([int(seed), zlib.crc32(name.encode()), int(index)])
    words = state.generate_state(2, np.uint32)
    return int(words[0]), int(words[1])
