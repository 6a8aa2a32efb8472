"""The general traffic generator: what a cell's ``traffic`` parameters
turn into.

- ``arrivals(n, rate, seed)``: an open loop of ``n`` requests at a mean
  ``rate`` a second. The gaps are the ``n`` quantiles of the exponential
  distribution (a Poisson process's gaps) in one fixed shuffled order,
  rotated by the seed: every seed offers the same load, with the same
  bursts, from another starting point. (Shuffling the gaps anew for each
  seed moved the 95th percentile by up to 13% between seeds, 1,787 to
  2,038 ms, m3 on an H100: the seed would change the work.)
- ``clips(seed, n, ...)``: ``n`` seed clips of moving sprites (bouncing
  blobs of random pixels, summed and clamped), float32 (n, frames, size,
  size, channels) in [0, 1], made on the host from the seed.
"""

from __future__ import annotations

import numpy as np


ORDER_SEED = 20260418


def arrivals(n: int, rate: float, seed: int) -> np.ndarray:
    """Due times (seconds from the window's start) of ``n`` requests."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = np.roll(gaps[np.random.default_rng(ORDER_SEED).permutation(n)], int(seed) % n)
    return np.cumsum(gaps) - gaps[0]


def clips(seed: int, n: int, frames: int, size: int, channels: int = 1, sprite: int = 24,
          sprites: int = 2, max_speed: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.zeros((n, frames, size + 2 * sprite, size + 2 * sprite, channels), np.float32)
    for i in range(n):
        for _ in range(sprites):
            patch = (rng.random((sprite, sprite, channels)) < 0.35) * rng.uniform(0.5, 1.0)
            y, x = rng.integers(0, size - sprite, 2)
            vy, vx = rng.integers(-max_speed, max_speed + 1, 2)
            for f in range(frames):
                out[i, f, sprite + y:2 * sprite + y, sprite + x:2 * sprite + x] += patch
                if not 0 <= y + vy <= size - sprite:
                    vy = -vy
                if not 0 <= x + vx <= size - sprite:
                    vx = -vx
                y, x = y + vy, x + vx
    return np.clip(out[:, :, sprite:sprite + size, sprite:sprite + size], 0.0, 1.0)
