"""Independent random streams drawn from ``--seed``: the same seed and keys
give the same numbers, whatever else a run draws."""

from __future__ import annotations

import zlib

import numpy as np


def _entropy(seed: int, keys) -> list[int]:
    out = [int(seed) % (1 << 64)]
    for key in keys:
        out.append(zlib.crc32(key.encode()) if isinstance(key, str) else int(key))
    return out


def generator(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed, keys)))


def torch_seed(seed: int, *keys) -> int:
    """A seed for ``torch.Generator.manual_seed``."""
    state = np.random.SeedSequence(_entropy(seed, keys)).generate_state(1, np.uint64)
    return int(state[0])
