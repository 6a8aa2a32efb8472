"""Trajectory frames, the clip samplers and the random-access clip view
(port of ``world_modelz_tpu.data.trajectory``).

- ``SyntheticTrajectorySource``: deterministic gameplay-like RGB clips (a
  scrolling textured background with moving coloured blocks), the offline
  stand-in for MineRL; the tokenizer trainer's default ``synthetic``
  dataset and the sparse trainer's. Its frames are rendered by the compiled
  compositor (``data/native.py:render_trajectory``) or its numpy path, the
  same bytes either way, so a seed gives JAX's frames.
- ``VideoFileTrajectorySource``: one trajectory per video file under a
  directory, decoded by OpenCV (imported when a file is read), RGB uint8,
  centre-cropped and resized to ``frame_size``.
- ``BufferedTrajectorySampler`` (reference:
  minecraft/buffered_traj_sampler.py:9-118): clips from a double buffer
  that a background thread fills, with the JAX package's numpy RNG stream,
  so a seed gives JAX's clips; ``SyncTrajectorySampler`` builds the same
  buffers in the caller's thread (minecraft/sample_frames.py:49-143).
- ``TrajectoryClipDataset``: record i a pure function of (seed, i), the
  random-access view ``data/grain_pipeline.py`` streams.

``MineRLTrajectorySource`` is not ported: the ``minerl`` package and its
data are absent (ROADMAP A.8).
"""

from __future__ import annotations

import queue
import threading
import os
from collections import OrderedDict
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from world_modelz_tpu_torch.data.native import render_trajectory


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
        # the motion in Python floats: the same float64 arithmetic as the
        # JAX package's numpy scalars (np.clip of a scalar is min(max())),
        # without their per-call overhead
        pos = rng.uniform(0, s - 12, (n_obj, 2)).tolist()
        vel = rng.uniform(-2.5, 2.5, (n_obj, 2)).tolist()
        colors = rng.uniform(80, 255, (n_obj, 3))
        sizes = rng.integers(6, 14, n_obj).tolist()

        shifts = np.empty((self.traj_frames,), np.int32)
        rects = np.empty((self.traj_frames, n_obj, 6), np.float32)
        rects[:, :, 2] = sizes
        rects[:, :, 3:] = colors
        for t in range(self.traj_frames):
            shifts[t] = int(t * 1.5) % s
            for i in range(n_obj):
                p, v, hi = pos[i], vel[i], s - sizes[i]
                rects[t, i, 0] = int(min(max(p[0], 0), hi))
                rects[t, i, 1] = int(min(max(p[1], 0), hi))
                p[0] += v[0]
                p[1] += v[1]
                for d in range(2):
                    if p[d] < 0 or p[d] > hi:
                        v[d] = -v[d]
                        p[d] = min(max(p[d], 0), hi)

        out = np.empty((self.traj_frames, s, s, 3), np.uint8)
        render_trajectory(out, np.clip(bg, 0, 255), shifts, rects)
        yield from out


class VideoFileTrajectorySource:
    """Trajectories from video files on disk (``EXTENSIONS``, via OpenCV).

    Each file under ``root`` (recursively by default) is one trajectory,
    named by its path relative to ``root``; frames are decoded as RGB uint8,
    cropped to the centre square and resized to ``frame_size`` (area
    interpolation)."""

    EXTENSIONS = (".mp4", ".avi", ".mkv", ".webm", ".mov")

    def __init__(self, root: str, frame_size: int = 64, recursive: bool = True):
        self.root = root
        self.frame_size = frame_size
        if recursive:
            names = [
                os.path.relpath(os.path.join(dirpath, f), root)
                for dirpath, _dirs, files in sorted(os.walk(root))
                for f in sorted(files) if f.lower().endswith(self.EXTENSIONS)
            ]
        else:
            names = sorted(f for f in os.listdir(root)
                           if f.lower().endswith(self.EXTENSIONS))
        if not names:
            raise FileNotFoundError(f"no video files under {root!r}")
        self._names = names

    def trajectory_names(self) -> Sequence[str]:
        return self._names

    def load_frames(self, name: str) -> Iterator[np.ndarray]:
        import cv2

        cap = cv2.VideoCapture(os.path.join(self.root, name))
        if not cap.isOpened():
            raise IOError(f"cannot open video {name!r}")
        s = self.frame_size
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                h, w = frame.shape[:2]
                side = min(h, w)
                y0, x0 = (h - side) // 2, (w - side) // 2
                frame = frame[y0: y0 + side, x0: x0 + side]
                if side != s:
                    frame = cv2.resize(frame, (s, s), interpolation=cv2.INTER_AREA)
                yield frame[:, :, ::-1].copy()  # BGR -> RGB
        finally:
            cap.release()


def _skip(frames, skip_frames: int) -> List[np.ndarray]:
    """Every ``skip_frames + 1``-th frame, starting with the first."""
    return list(frames)[:: skip_frames + 1]


class _Buffer:
    __slots__ = ("segments", "example_offsets")

    def __init__(self, segments: List[np.ndarray],
                 example_offsets: List[Tuple[int, int]]):
        self.segments = segments
        self.example_offsets = example_offsets


class _SamplerBase:
    """The buffer both samplers draw clips from (buffered_traj_sampler.py:
    32-118): trajectories visited in random permutation order, frames kept
    every ``skip_frames + 1`` steps, a random segment of at most
    ``max_segment_length`` frames kept, and one training-example offset
    drawn per ``sample_divisor`` frames of each segment."""

    def __init__(self, source, buffer_size: int, max_segment_length: int,
                 traj_len: int, skip_frames: int, sample_divisor: int):
        self.source = source
        self.buffer_size = buffer_size
        self.max_segment_length = max_segment_length
        self.traj_len = traj_len
        self.skip_frames = skip_frames
        self.sample_divisor = sample_divisor
        self._stop = threading.Event()

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
            frames = _skip(self.source.load_frames(name), self.skip_frames)
            if len(frames) <= self.traj_len:
                continue
            max_offset = len(frames) - self.max_segment_length
            if max_offset > 0:
                begin = int(rng.integers(0, max_offset + 1))
                frames = frames[begin: begin + self.max_segment_length]
            seg_idx = len(segments)
            segments.append(np.stack(frames))
            total_frames += len(frames)
            n_examples = (len(frames) - self.traj_len) // self.sample_divisor
            for _ in range(n_examples):
                off = int(rng.integers(0, len(frames) - self.traj_len + 1))
                offsets.append((seg_idx, off))
        perm = rng.permutation(len(offsets))
        return _Buffer(segments, [offsets[int(k)] for k in perm])

    def _next_clip(self) -> np.ndarray:
        raise NotImplementedError

    def sample_batch(self, batch_size: int) -> np.ndarray:
        """(B, traj_len, H, W, 3) uint8 clips (buffered_traj_sampler.py:
        104-118)."""
        out = None
        for b in range(batch_size):
            clip = self._next_clip()
            if out is None:
                out = np.empty((batch_size,) + clip.shape, dtype=clip.dtype)
            out[b] = clip
        return out


class BufferedTrajectorySampler(_SamplerBase):
    """Double-buffered batch sampler over a trajectory source: a daemon
    thread builds the next buffer while the consumer samples the current
    one; completed buffers pass through a one-slot queue. The worker's
    generator is seeded from ``default_rng(seed).integers(2**63)``, as the
    JAX package seeds it."""

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
        super().__init__(source, buffer_size, max_segment_length, traj_len,
                         skip_frames, sample_divisor)
        self._rng = np.random.default_rng(seed)
        self._queue: "queue.Queue[_Buffer]" = queue.Queue(maxsize=1)
        self._current: Optional[_Buffer] = None
        self._cursor = 0
        self._thread = threading.Thread(target=self._fill_loop, daemon=True)
        self._thread.start()

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

    def _next_clip(self) -> np.ndarray:
        while self._current is None or self._cursor >= len(self._current.example_offsets):
            self._current = self._queue.get()
            self._cursor = 0
        seg_idx, off = self._current.example_offsets[self._cursor]
        self._cursor += 1
        return self._current.segments[seg_idx][off: off + self.traj_len]

    def close(self):
        """Stop the fill thread (it exits at its next check) and free the
        queued buffer."""
        self._stop.set()
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass


class SyncTrajectorySampler(_SamplerBase):
    """The buffered sampler without its thread (minecraft/sample_frames.py:
    49-143): ``sample_batch`` rebuilds the buffer in the caller's thread when
    it runs out, drawing from ``default_rng(seed)`` itself."""

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
        super().__init__(source, buffer_size, max_segment_length, traj_len,
                         skip_frames, sample_divisor)
        self._rng = np.random.default_rng(seed)
        self._buffer: Optional[_Buffer] = None
        self._cursor = 0

    def _next_clip(self) -> np.ndarray:
        while self._buffer is None or self._cursor >= len(self._buffer.example_offsets):
            self._buffer = self._build_buffer(self._rng)
            self._cursor = 0
        seg_idx, off = self._buffer.example_offsets[self._cursor]
        self._cursor += 1
        return self._buffer.segments[seg_idx][off: off + self.traj_len]

    def close(self):
        """Nothing to stop (the trainers' sampler protocol)."""


class TrajectoryClipDataset:
    """Random-access clip view over a trajectory source, the record stream
    ``data/grain_pipeline.py`` samples: record ``i`` is a pure function of
    ``(seed, i)`` (a per-index generator picks the trajectory and the clip
    offset), so a stream over it resumes exactly and shards.

    Frames are kept every ``skip_frames + 1`` steps, as the samplers keep
    them; a trajectory with no more than ``traj_len`` of them is passed over
    for the next in the record's order, at most ``max_draws`` times. Decoded
    trajectories pass through an LRU of ``cache_size``."""

    def __init__(
        self,
        source,
        traj_len: int = 16,
        skip_frames: int = 2,
        examples_per_epoch: int = 100_000,
        cache_size: int = 4,
        seed: int = 0,
        max_draws: int = 8,
    ):
        self.source = source
        self.traj_len = traj_len
        self.skip_frames = skip_frames
        self.seed = seed
        self.max_draws = max_draws
        self._n = examples_per_epoch
        self._names = list(source.trajectory_names())
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._cache_size = cache_size

    def __len__(self) -> int:
        return self._n

    def __repr__(self) -> str:
        # Grain checks repr(data_source) when it restores a state: no
        # object address in it
        return (
            f"TrajectoryClipDataset(source={type(self.source).__name__},"
            f" n={self._n}, traj_len={self.traj_len},"
            f" skip={self.skip_frames}, seed={self.seed})"
        )

    def _decoded(self, name: str) -> np.ndarray:
        hit = self._cache.pop(name, None)
        if hit is None:
            frames = _skip(self.source.load_frames(name), self.skip_frames)
            hit = np.stack(frames) if frames else np.empty((0, 1, 1, 3), np.uint8)
        self._cache[name] = hit  # the newest entry
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return hit

    def __getitem__(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, int(i)]))
        order = rng.permutation(len(self._names))
        for t in order[: self.max_draws]:
            frames = self._decoded(self._names[int(t)])
            if len(frames) > self.traj_len:
                off = int(rng.integers(0, len(frames) - self.traj_len + 1))
                return frames[off: off + self.traj_len]
        raise ValueError(
            f"no trajectory longer than traj_len={self.traj_len} "
            f"(post-skip) in {self.max_draws} draws — shorten traj_len "
            f"or lower skip_frames")
