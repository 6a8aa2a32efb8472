"""Procedural trajectory frames and the buffered clip sampler (port of
``world_modelz_tpu.data.trajectory``: the synthetic source and
``BufferedTrajectorySampler``).

``SyntheticTrajectorySource`` is the tokenizer trainer's default
``dataset="synthetic"`` and the sparse trainer's: deterministic
gameplay-like RGB clips (a scrolling textured background with moving
coloured blocks), the offline stand-in for MineRL. The frames are rendered
by the numpy version of the JAX package's renderer
(``data/native.py:render_trajectory``), which the compiled compositor
matches exactly, so a seed gives JAX's frames. ``BufferedTrajectorySampler``
(reference: minecraft/buffered_traj_sampler.py:9-118) draws clips from a
double buffer that a background thread fills, with the JAX package's numpy
RNG stream, so a seed gives JAX's clips. ``MineRLTrajectorySource``,
``VideoFileTrajectorySource``, ``SyncTrajectorySampler`` and the grain
clip dataset are not ported (ROADMAP A.8).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Sequence, Tuple

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


class _Buffer:
    __slots__ = ("segments", "example_offsets")

    def __init__(self, segments: List[np.ndarray],
                 example_offsets: List[Tuple[int, int]]):
        self.segments = segments
        self.example_offsets = example_offsets


class BufferedTrajectorySampler:
    """Double-buffered batch sampler over a trajectory source
    (buffered_traj_sampler.py:32-118).

    Trajectories are visited in random permutation order, frames are kept
    every ``skip_frames + 1`` steps, a random segment of at most
    ``max_segment_length`` frames survives, and one training-example
    offset is drawn per ``sample_divisor`` frames of each segment. A
    daemon thread builds the next buffer while the consumer samples the
    current one; completed buffers pass through a one-slot queue. The
    worker's generator is seeded from ``default_rng(seed).integers(2**63)``,
    as the JAX package seeds it.
    """

    def __init__(
        self,
        source,
        buffer_size: int = 100_000,
        max_segment_length: int = 1000,
        traj_len: int = 16,
        skip_frames: int = 2,
        seed: int = 0,
        sample_divisor: int = 8,
    ):
        self.source = source
        self.buffer_size = buffer_size
        self.max_segment_length = max_segment_length
        self.traj_len = traj_len
        self.skip_frames = skip_frames
        self.sample_divisor = sample_divisor
        self._rng = np.random.default_rng(seed)
        self._queue: "queue.Queue[_Buffer]" = queue.Queue(maxsize=1)
        self._current: "_Buffer | None" = None
        self._cursor = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill_loop, daemon=True)
        self._thread.start()

    def _build_buffer(self, rng: np.random.Generator) -> _Buffer:
        names = list(self.source.trajectory_names())
        total_frames = 0
        segments: List[np.ndarray] = []
        offsets: List[Tuple[int, int]] = []
        order: List[int] = []
        i = 0
        while total_frames < self.buffer_size and not self._stop.is_set():
            if i >= len(order):
                order = list(rng.permutation(len(names)))
                i = 0
            name = names[order[i]]
            i += 1
            # keep every (skip_frames + 1)-th frame, starting with the first
            frames = list(self.source.load_frames(name))[:: self.skip_frames + 1]
            if len(frames) <= self.traj_len:
                continue
            max_offset = len(frames) - self.max_segment_length
            if max_offset > 0:
                begin = int(rng.integers(0, max_offset + 1))
                frames = frames[begin : begin + self.max_segment_length]
            seg_idx = len(segments)
            segments.append(np.stack(frames))
            total_frames += len(frames)
            n_examples = (len(frames) - self.traj_len) // self.sample_divisor
            for _ in range(n_examples):
                off = int(rng.integers(0, len(frames) - self.traj_len + 1))
                offsets.append((seg_idx, off))
        perm = rng.permutation(len(offsets))
        return _Buffer(segments, [offsets[int(k)] for k in perm])

    def _fill_loop(self):
        worker_rng = np.random.default_rng(self._rng.integers(2**63))
        while not self._stop.is_set():
            buf = self._build_buffer(worker_rng)
            while not self._stop.is_set():
                try:
                    self._queue.put(buf, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def _next_example(self) -> Tuple[int, int]:
        while self._current is None or self._cursor >= len(
                self._current.example_offsets):
            self._current = self._queue.get()
            self._cursor = 0
        ex = self._current.example_offsets[self._cursor]
        self._cursor += 1
        return ex

    def sample_batch(self, batch_size: int) -> np.ndarray:
        """(B, traj_len, H, W, 3) uint8 clips (buffered_traj_sampler.py:
        104-118)."""
        out = None
        for b in range(batch_size):
            seg_idx, off = self._next_example()
            clip = self._current.segments[seg_idx][off : off + self.traj_len]
            if out is None:
                out = np.empty((batch_size,) + clip.shape, dtype=clip.dtype)
            out[b] = clip
        return out

    def close(self):
        """Stop the fill thread (it exits at its next check) and free the
        queued buffer."""
        self._stop.set()
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
