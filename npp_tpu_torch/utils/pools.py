"""Coordinate-pool padding: one implementation for the three call sites
(sampler pools, pixel pools, ranking pools).

Pools pad to a power-of-two length so compiled executables are reused across
images; the true count is returned separately and bounds the random index
draws, so padding rows are never oversampled.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_pool_pow2(pool: np.ndarray, fallback_row=None,
                  fill: str = 'tile') -> Tuple[np.ndarray, int]:
    """Pad (N, 2) int coords to the next power of two.

    Returns (padded int32 array, true count). An empty pool is replaced by a
    single `fallback_row` (default zeros) with true count 0.
    fill: 'tile' repeats the whole pool cyclically; 'first' repeats row 0.
    """
    pool = np.asarray(pool)
    n = len(pool)
    if n == 0:
        row = np.zeros((1, 2), np.int64) if fallback_row is None \
            else np.asarray(fallback_row, np.int64).reshape(1, 2)
        return row.astype(np.int32), 0
    target = int(2 ** np.ceil(np.log2(n)))
    pad = target - n
    if pad:
        if fill == 'tile':
            reps = -(-target // n)
            pool = np.tile(pool, (reps, 1))[:target]
        else:
            pool = np.concatenate([pool, np.repeat(pool[:1], pad, 0)])
    return pool.astype(np.int32), n
