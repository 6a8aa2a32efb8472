"""Image grids, PNG files and animated GIFs (port of
``world_modelz_tpu.utils.image``: ``make_grid``, ``save_image`` and
``save_gif``), with readers for both formats.

Images are NHWC float in [0, 1] (grayscale NHW1 or RGB NHW3). Everything
here is the standard library (``zlib``, ``struct``) and numpy, so no
imaging package is needed:
- ``save_image`` writes an 8-bit PNG; ``read_png`` reads 8-bit grayscale,
  RGB and RGBA PNGs that are not interlaced (all five row filters), and
  raises on any other PNG.
- ``save_gif`` writes a GIF89a that loops (a NETSCAPE2.0 block) with one
  frame per image, each LZW-coded. Grayscale frames take a palette of the
  256 grays, so they decode to their uint8 pixels exactly; RGB frames are
  dithered (Floyd-Steinberg) onto the 216-colour web palette, which is what
  PIL's ``convert("P")`` in the JAX writer does. ``read_gif`` decodes a
  GIF to its frames as RGB.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the web palette's levels per channel (PIL's "browser" colour cube)
_WEB_STEP = 51


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


# ----------------------------------------------------------------------- PNG


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
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
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


def _unfilter_row(kind: int, row: bytes, prior: bytes, bpp: int) -> bytes:
    """Undo one PNG row filter (None, Sub, Up, Average, Paeth)."""
    if kind == 0:
        return row
    if kind == 1:
        r = np.frombuffer(row, np.uint8).reshape(-1, bpp)
        return np.cumsum(r, axis=0, dtype=np.uint8).tobytes()
    if kind == 2:
        return (np.frombuffer(row, np.uint8)
                + np.frombuffer(prior, np.uint8)).tobytes()
    out = bytearray(row)
    if kind == 3:
        for i in range(len(out)):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prior[i]) >> 1)) & 0xFF
        return bytes(out)
    if kind == 4:
        for i in range(len(out)):
            a = out[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
        return bytes(out)
    raise ValueError(f"PNG row filter {kind} is not one of 0-4")


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG -> (H, W, C) uint8, C = 1 (grayscale), 3 (RGB) or 4
    (RGBA). Other PNGs (16-bit, palette, gray + alpha, interlaced) raise
    ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    channels = {0: 1, 2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {color_type}, "
            f"interlace {interlace}; read_png takes 8-bit grayscale, RGB or "
            "RGBA without interlacing")
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of pixel data for "
                         f"{w} x {h} x {channels}")
    rows, prior = [], bytes(stride)
    for y in range(h):
        at = y * (stride + 1)
        prior = _unfilter_row(raw[at], raw[at + 1:at + 1 + stride], prior,
                              channels)
        rows.append(prior)
    return np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, channels)


# ----------------------------------------------------------------------- GIF


def _web_dither(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) indices into the web palette
    (``_web_palette``), Floyd-Steinberg dithered. A pixel waits only on
    its left neighbour and the three above it, so the pixels with x + 2y
    equal are dithered together, one wave at a time."""
    h, w, _ = rgb.shape
    err = np.zeros((h + 1, w + 2, 3), np.float32)
    src = rgb.astype(np.float32)
    levels = np.zeros((h, w, 3), np.int64)
    ys_all = np.arange(h)
    for t in range(w + 2 * (h - 1)):
        xs = t - 2 * ys_all
        keep = (xs >= 0) & (xs < w)
        ys, xs = ys_all[keep], xs[keep]
        v = np.clip(src[ys, xs] + err[ys, xs + 1], 0.0, 255.0)
        lv = np.rint(v / _WEB_STEP).astype(np.int64)
        levels[ys, xs] = lv
        e = v - lv * np.float32(_WEB_STEP)
        err[ys, xs + 2] += e * (7 / 16)
        err[ys + 1, xs] += e * (3 / 16)
        err[ys + 1, xs + 1] += e * (5 / 16)
        err[ys + 1, xs + 2] += e * (1 / 16)
    return (levels[..., 0] + 6 * levels[..., 1] + 36 * levels[..., 2]).astype(np.uint8)


def _web_palette() -> np.ndarray:
    """(256, 3) uint8: the 6 x 6 x 6 colour cube (red fastest), then black."""
    pal = np.zeros((256, 3), np.uint8)
    lv = np.arange(216)
    pal[:216] = np.stack([lv % 6, lv // 6 % 6, lv // 36], axis=1) * _WEB_STEP
    return pal


def _lzw_encode(indices: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW (codes of 9 to 12 bits, LSB first; a clear
    code when the table is full)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    width, next_code, table = min_size + 1, eoi + 1, {}
    emit(clear, width)
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear, width)
            width, next_code, table = min_size + 1, eoi + 1, {}
        prefix = k
    emit(prefix, width)
    emit(eoi, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _lzw_decode(data: bytes, min_size: int, npix: int) -> bytes:
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    data = data + b"\x00\x00\x00"
    end_bits = 8 * (len(data) - 3)
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, width, prev = list(base), min_size + 1, None
    out = bytearray()
    pos = 0
    while pos + width <= end_bits and len(out) < npix:
        code = (int.from_bytes(data[pos >> 3:(pos >> 3) + 3], "little")
                >> (pos & 7)) & ((1 << width) - 1)
        pos += width
        if code == clear:
            table, width, prev = list(base), min_size + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"GIF: LZW code {code} past the table")
            if len(table) < 4096:
                table.append(prev + entry[:1])
                if len(table) == (1 << width) and width < 12:
                    width += 1
        out += entry
        prev = entry
    if len(out) < npix:
        raise ValueError(f"GIF: {len(out)} of {npix} pixels in a frame")
    return bytes(out[:npix])


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def save_gif(
    frames: Sequence[np.ndarray],
    path: str,
    fps: float = 8.0,
    loop: int = 0,
) -> None:
    """Assemble (H, W, C) float [0, 1] frames into an animated GIF
    (make_gif.sh equivalent): grayscale exactly, RGB dithered onto the web
    palette; each frame shows for ``int(1000 / fps)`` ms."""
    arrs = [_to_uint8(np.asarray(f)) for f in frames]
    if not arrs:
        raise ValueError("save_gif needs at least one frame")
    h, w = arrs[0].shape[:2]
    gray = arrs[0].ndim == 2 or arrs[0].shape[-1] == 1
    if gray:
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    else:
        palette = _web_palette()
    # PIL stores a duration in centiseconds, int(ms / 10)
    delay = int(int(1000 / fps) / 10)
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           palette.tobytes(),
           b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for arr in arrs:
        if arr.shape[:2] != (h, w):
            raise ValueError(f"GIF frames differ in size: {arr.shape[:2]} vs {(h, w)}")
        if gray:
            idx = arr.reshape(h, w, -1)[..., 0]
        else:
            idx = _web_dither(arr[..., :3])
        out.append(b"\x21\xF9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(b"\x08" + _sub_blocks(_lzw_encode(idx.tobytes())))
    out.append(b"\x3B")
    with open(path, "wb") as f:
        f.write(b"".join(out))


def read_gif(path: str) -> np.ndarray:
    """A GIF -> (T, H, W, 3) uint8 frames: each frame's pixels over the
    canvas the frames before it left (disposal 0-2, transparency).
    Interlaced frames raise ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path} is not a GIF file")
    w, h, packed, bg, _ = struct.unpack("<HHBBB", data[6:13])
    pos = 13
    gct = None
    if packed & 0x80:
        n = 2 << (packed & 7)
        gct = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    canvas = np.zeros((h, w, 3), np.uint8)
    frames: List[np.ndarray] = []
    transparent, disposal = None, 0

    def blocks(at):
        parts = []
        while data[at]:
            parts.append(data[at + 1:at + 1 + data[at]])
            at += 1 + data[at]
        return b"".join(parts), at + 1

    while pos < len(data):
        kind = data[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            label = data[pos + 1]
            body, pos = blocks(pos + 2)
            if label == 0xF9:
                flags = body[0]
                disposal = (flags >> 2) & 7
                transparent = body[3] if flags & 1 else None
            continue
        if kind != 0x2C:
            raise ValueError(f"{path}: unknown GIF block 0x{kind:02x}")
        x0, y0, fw, fh, fpacked = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
        pos += 10
        pal = gct
        if fpacked & 0x80:
            n = 2 << (fpacked & 7)
            pal = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
            pos += 3 * n
        if fpacked & 0x40:
            raise ValueError(f"{path}: interlaced GIF frames are not read")
        if pal is None:
            raise ValueError(f"{path}: a frame without a colour table")
        min_size = data[pos]
        lzw, pos = blocks(pos + 1)
        idx = np.frombuffer(_lzw_decode(lzw, min_size, fw * fh), np.uint8)
        idx = idx.reshape(fh, fw)
        region = canvas[y0:y0 + fh, x0:x0 + fw]
        keep = (np.ones_like(idx, bool) if transparent is None
                else idx != transparent)
        region[keep] = pal[np.minimum(idx, len(pal) - 1)][keep]
        frames.append(canvas.copy())
        if disposal == 2:
            region[...] = gct[bg] if gct is not None else 0
        elif disposal == 3:
            raise ValueError(f"{path}: disposal 3 (restore previous) is not read")
        transparent, disposal = None, 0
    return np.stack(frames)
