"""Image grids and PNG files (port of ``world_modelz_tpu.utils.image``:
``make_grid`` and ``save_image``).

Images are NHWC float in [0, 1] (grayscale NHW1 or RGB NHW3). PNGs are
written with the standard library (``zlib``, ``struct``), 8 bits per
channel, so no imaging package is needed. ``save_gif`` is not ported
(ROADMAP A.8).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.nan_to_num(np.asarray(img, np.float32))
    img = np.clip(img, 0.0, 1.0)
    return (img * 255.0 + 0.5).astype(np.uint8)


def make_grid(
    images: np.ndarray,
    nrow: int = 8,
    pad: int = 2,
    pad_value: float = 0.2,
) -> np.ndarray:
    """Tile (N, H, W, C) images into a (GH, GW, C) grid (torchvision-style)."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[..., None]
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.full(
        (nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
        pad_value,
        np.float32,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y : y + h, x : x + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_bytes(arr: np.ndarray) -> bytes:
    """(H, W) grayscale, or (H, W, 3) RGB, (H, W, 4) RGBA uint8 -> a PNG
    file's bytes (no filtering, zlib level 6)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}.get(c)
    if color_type is None:
        raise ValueError(f"PNG takes 1, 3 or 4 channels, got {c}")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image(img: np.ndarray, path: str) -> None:
    """Save (H, W, C) or (N, H, W, C) float [0,1] image(s) as PNG (batches
    are gridded first)."""
    img = np.asarray(img)
    if img.ndim == 4:
        img = make_grid(img)
    arr = _to_uint8(img)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    with open(path, "wb") as f:
        f.write(_png_bytes(arr))
