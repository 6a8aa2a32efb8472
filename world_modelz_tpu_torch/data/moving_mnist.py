"""Procedural bouncing-digits video generator (MovingMNIST).

A jax-free copy of ``world_modelz_tpu.data.moving_mnist`` (reference:
vq-video-diffusion/data/moving_mnist.py:7-95): per-index deterministic
seeding, bouncing dynamics with optional velocity re-randomization at wall
hits, float32 (seq_len, H, W, 1) clips clipped to [0, 1]. Digit sprites
come from ``mnist.npz`` under ``data_root`` when present, else from the
built-in seven-segment renderer. The JAX module cannot be imported here
(its package imports jax), so the port keeps its own copy; the tests hold
the two clip by clip.

Sprites are composited by the port's compiled compositor
(``data/native.py``: ``+=`` into the frame, then a clamp to [0, 1]), or by
its numpy path, which gives the same float32 bytes, as the JAX package's.
``sample_batch_traj`` ships each clip's sprites and positions instead of its
pixels, for compositing inside the step on the device
(``data/device_composite.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from world_modelz_tpu_torch.data import native

# seven-segment layouts for digits 0-9: (a, b, c, d, e, f, g)
_SEGMENTS = {
    0: "abcdef",
    1: "bc",
    2: "abged",
    3: "abgcd",
    4: "fgbc",
    5: "afgcd",
    6: "afgedc",
    7: "abc",
    8: "abcdefg",
    9: "abcfgd",
}


def _render_glyph(digit: int, size: int) -> np.ndarray:
    """Anti-aliased seven-segment digit bitmap in [0, 1], shape (size, size)."""
    hi = size * 4  # supersample
    img = np.zeros((hi, hi), np.float32)
    t = max(2, hi // 8)  # stroke thickness
    m = hi // 8  # margin
    x0, x1 = m, hi - m
    y0, y1, y2 = m, hi // 2, hi - m

    def hseg(y, xa, xb):
        img[max(0, y - t // 2) : y + t // 2, xa:xb] = 1.0

    def vseg(x, ya, yb):
        img[ya:yb, max(0, x - t // 2) : x + t // 2] = 1.0

    segs = _SEGMENTS[digit % 10]
    if "a" in segs:
        hseg(y0, x0, x1)
    if "g" in segs:
        hseg(y1, x0, x1)
    if "d" in segs:
        hseg(y2, x0, x1)
    if "f" in segs:
        vseg(x0, y0, y1)
    if "b" in segs:
        vseg(x1, y0, y1)
    if "e" in segs:
        vseg(x0, y1, y2)
    if "c" in segs:
        vseg(x1, y1, y2)

    # box-filter downsample for soft edges (MNIST-ish strokes)
    img = img.reshape(size, 4, size, 4).mean(axis=(1, 3))
    return np.clip(img * 1.4, 0.0, 1.0)


def _load_digit_bank(data_root: Optional[str], digit_size: int) -> np.ndarray:
    """(N, digit_size, digit_size) float32 sprites in [0, 1]."""
    if data_root:
        for name in ("mnist.npz", "MNIST/mnist.npz"):
            path = os.path.join(data_root, name)
            if os.path.isfile(path):
                with np.load(path) as f:
                    key = "x_train" if "x_train" in f else "images"
                    imgs = f[key].astype(np.float32)
                if imgs.max() > 1.5:
                    imgs = imgs / 255.0
                bank = np.zeros(
                    (len(imgs), digit_size, digit_size), np.float32
                )
                for i, im in enumerate(imgs):
                    bank[i] = _resize_bilinear(im, digit_size)
                return bank
    return np.stack([_render_glyph(d, digit_size) for d in range(10)])


def _resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    return (
        img[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
        + img[np.ix_(y1, x0)] * wy * (1 - wx)
        + img[np.ix_(y0, x1)] * (1 - wy) * wx
        + img[np.ix_(y1, x1)] * wy * wx
    )


class MovingMNIST:
    """Bouncing-digit clip dataset; `ds[i]` -> (seq_len, H, W, 1) float32."""

    def __init__(
        self,
        train: bool = True,
        data_root: Optional[str] = None,
        seq_len: int = 20,
        num_digits: int = 2,
        image_size: int = 64,
        digit_size: int = 24,
        deterministic: bool = True,
        length: int = 60000,
    ):
        self.seq_len = seq_len
        self.num_digits = num_digits
        self.image_size = image_size
        self.digit_size = digit_size
        self.deterministic = deterministic
        self.max_velocity = digit_size // 5  # (:16)
        self.length = length
        self.bank = _load_digit_bank(data_root, digit_size)

    def __len__(self) -> int:
        return self.length

    def __repr__(self) -> str:
        return (
            f"MovingMNIST(seq_len={self.seq_len}, "
            f"num_digits={self.num_digits}, "
            f"image_size={self.image_size}, "
            f"digit_size={self.digit_size}, "
            f"deterministic={self.deterministic}, length={self.length})"
        )

    def _digit_track(
        self, rng: np.random.Generator
    ) -> tuple:
        """Bounce-dynamics integration (moving_mnist.py:59-88): returns the
        sprite-bank index and the (seq_len, 2) (y, x) positions."""
        size, digit_size = self.image_size, self.digit_size
        lo, hi = -self.max_velocity, self.max_velocity + 1
        bank_idx = int(rng.integers(len(self.bank)))
        sx = int(rng.integers(size - digit_size))
        sy = int(rng.integers(size - digit_size))
        dx = int(rng.integers(lo, hi))
        dy = int(rng.integers(lo, hi))
        pos = np.empty((self.seq_len, 2), np.int32)
        for t in range(self.seq_len):
            if sy < 0:
                sy = 0
                if self.deterministic:
                    dy = -dy
                else:
                    dy = int(rng.integers(1, hi))
                    dx = int(rng.integers(lo, hi))
            elif sy >= size - digit_size:
                sy = size - digit_size - 1
                if self.deterministic:
                    dy = -dy
                else:
                    dy = int(rng.integers(lo, 0))
                    dx = int(rng.integers(lo, hi))
            if sx < 0:
                sx = 0
                if self.deterministic:
                    dx = -dx
                else:
                    dx = int(rng.integers(1, hi))
                    dy = int(rng.integers(lo, hi))
            elif sx >= size - digit_size:
                sx = size - digit_size - 1
                if self.deterministic:
                    dx = -dx
                else:
                    dx = int(rng.integers(lo, 0))
                    dy = int(rng.integers(lo, hi))
            pos[t] = (sy, sx)
            sy += dy
            sx += dx
        return bank_idx, pos

    def __getitem__(self, index: int) -> np.ndarray:
        rng = np.random.default_rng(index)
        size = self.image_size
        x = np.zeros((self.seq_len, size, size), np.float32)
        for _ in range(self.num_digits):
            bank_idx, pos = self._digit_track(rng)
            native.composite_sprite(x, self.bank[bank_idx], pos)
        native.clamp01(x)
        return x[..., None]

    def sample_batch(self, rng: np.random.Generator, batch_size: int) -> np.ndarray:
        """(B, seq_len, H, W, 1) float32 batch of random clips."""
        idx = rng.integers(0, self.length, batch_size)
        return np.stack([self[int(i)] for i in idx])

    def sample_batch_u8(
        self, rng: np.random.Generator, batch_size: int
    ) -> np.ndarray:
        """(B, seq_len, H, W, 1) uint8 batch — same clips quantized to
        1/255 steps. The trainer ships these and normalizes on the device
        (a quarter of the float32 bytes)."""
        x = self.sample_batch(rng, batch_size)
        return (x * 255.0 + 0.5).astype(np.uint8)

    def sample_batch_traj(self, rng: np.random.Generator, batch_size: int) -> dict:
        """A trajectory batch for compositing on the device: each clip's
        sprites and per-frame positions, from the same per-index RNG stream
        as ``__getitem__`` (so clip i composited on the device is clip i
        with its sprites quantized to 1/255).

        Returns {'sprites': (B, D, K, K) uint8, 'pos': (B, D, S, 2) int32}.
        """
        if not hasattr(self, "_bank_u8"):
            self._bank_u8 = (self.bank * 255.0 + 0.5).astype(np.uint8)
        idx = rng.integers(0, self.length, batch_size)
        d, k = self.num_digits, self.digit_size
        sprites = np.empty((batch_size, d, k, k), np.uint8)
        pos = np.empty((batch_size, d, self.seq_len, 2), np.int32)
        for i, index in enumerate(idx):
            r = np.random.default_rng(int(index))
            for j in range(d):
                bank_idx, p = self._digit_track(r)
                sprites[i, j] = self._bank_u8[bank_idx]
                pos[i, j] = p
        return {"sprites": sprites, "pos": pos}
