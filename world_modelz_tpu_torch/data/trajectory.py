"""Procedural trajectory frames (port of ``world_modelz_tpu.data.trajectory``,
the synthetic source only).

``SyntheticTrajectorySource`` is the tokenizer trainer's default
``dataset="synthetic"``: deterministic gameplay-like RGB clips (a
scrolling textured background with moving coloured blocks), the offline
stand-in for MineRL. The frames are rendered by the numpy version of the
JAX package's renderer (``data/native.py:render_trajectory``), which the
compiled compositor matches exactly, so a seed gives JAX's frames.
``MineRLTrajectorySource``, ``VideoFileTrajectorySource`` and the samplers
are not ported (ROADMAP A.8).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


def render_trajectory(
    out: np.ndarray, bg: np.ndarray, shifts: np.ndarray, rects: np.ndarray
) -> None:
    """out (T, H, W, 3) uint8 <- the background scrolled by ``shifts[t]``
    (bg is (H, 2W, 3)), clipped to [0, 255] and truncated, with the
    rectangles ``rects[t, i] = (y0, x0, size, r, g, b)`` painted over it."""
    t, h, w, _ = out.shape
    for i in range(t):
        shift = int(shifts[i]) % w
        frame = np.clip(bg[:, shift : shift + w], 0, 255).astype(np.uint8)
        for r in rects[i]:
            y0, x0, k = int(r[0]), int(r[1]), int(r[2])
            y0c, y1c = max(0, y0), min(h, y0 + k)
            x0c, x1c = max(0, x0), min(w, x0 + k)
            frame[y0c:y1c, x0c:x1c] = r[3:6].astype(np.uint8)
        out[i] = frame


class SyntheticTrajectorySource:
    """Deterministic procedural gameplay-like clips: a scrolling textured
    background with moving coloured blocks. Trajectory ``i`` draws from
    ``default_rng(seed * 10007 + i)``."""

    def __init__(
        self,
        num_trajectories: int = 8,
        traj_frames: int = 400,
        frame_size: int = 64,
        seed: int = 0,
    ):
        self.num_trajectories = num_trajectories
        self.traj_frames = traj_frames
        self.frame_size = frame_size
        self.seed = seed

    def trajectory_names(self) -> Sequence[str]:
        return [f"synthetic-{i:04d}" for i in range(self.num_trajectories)]

    def load_frames(self, name: str) -> Iterator[np.ndarray]:
        """Yield the (H, W, 3) uint8 frames of trajectory ``name``."""
        idx = int(name.rsplit("-", 1)[1])
        rng = np.random.default_rng(self.seed * 10007 + idx)
        s = self.frame_size
        # textured background, twice as wide for scrolling
        bg = (rng.uniform(40, 160, (s, 2 * s, 3))).astype(np.float32)
        bg += rng.uniform(-20, 20, (s, 2 * s, 1))
        n_obj = int(rng.integers(2, 5))
        pos = rng.uniform(0, s - 12, (n_obj, 2))
        vel = rng.uniform(-2.5, 2.5, (n_obj, 2))
        colors = rng.uniform(80, 255, (n_obj, 3))
        sizes = rng.integers(6, 14, n_obj)

        shifts = np.empty((self.traj_frames,), np.int32)
        rects = np.empty((self.traj_frames, n_obj, 6), np.float32)
        for t in range(self.traj_frames):
            shifts[t] = int(t * 1.5) % s
            for i in range(n_obj):
                y, x = pos[i]
                k = int(sizes[i])
                y0 = int(np.clip(y, 0, s - k))
                x0 = int(np.clip(x, 0, s - k))
                rects[t, i] = (y0, x0, k, *colors[i])
                pos[i] += vel[i]
                for d in range(2):
                    if pos[i, d] < 0 or pos[i, d] > s - k:
                        vel[i, d] = -vel[i, d]
                        pos[i, d] = np.clip(pos[i, d], 0, s - k)

        out = np.empty((self.traj_frames, s, s, 3), np.uint8)
        render_trajectory(out, np.clip(bg, 0, 255), shifts, rects)
        yield from out
