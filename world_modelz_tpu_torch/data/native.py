"""ctypes loader for the host data pipeline's compiled compositor.

Port of ``world_modelz_tpu.data.native``: the same three entry points
(``composite_sprite``, ``clamp01``, ``render_trajectory``) with the same
signatures, over the port's own copy of ``_native/compositor.cpp``. At first
use the source is built with ``g++ -O3 -shared -fPIC`` into ``build/native/``
at the repository root, the library named by a digest of the flags and the
source (an edited source is rebuilt, an unchanged one loaded as it is), and
never beside the source. Every entry point takes its numpy path under
``WMZ_DISABLE_NATIVE`` or when no compiler is found; both paths give the same
bytes. ``backend()`` says which path runs: ``"compiled"`` or ``"numpy"``,
and ``failure()`` why the compiled one does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native", "compositor.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "native",
)
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_STATE = {"tried": False, "lib": None, "failure": None}


def _library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwmz_compositor_{h.hexdigest()[:16]}.so")


def _build_and_load() -> ctypes.CDLL:
    """Build the library unless its digest's file exists, load it, bind the
    entry points. Raises OSError or SubprocessError on any failure."""
    path = _library_path()
    if not os.path.exists(path):
        cxx = shutil.which("g++")
        if cxx is None:
            raise FileNotFoundError("g++ not found on PATH")
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, os.path.basename(path))
            subprocess.run([cxx, *CXX_FLAGS, _SRC, "-o", out], check=True,
                           capture_output=True, timeout=120)
            os.replace(out, path)  # atomic: never a half-written library
    lib = ctypes.CDLL(path)
    fp, i32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.composite_sprite.argtypes = [fp] + [ctypes.c_int] * 3 + [fp, ctypes.c_int, i32]
    lib.composite_sprite.restype = None
    lib.clamp01.argtypes = [fp, ctypes.c_int64]
    lib.clamp01.restype = None
    lib.render_trajectory.argtypes = (
        [ctypes.POINTER(ctypes.c_uint8)] + [ctypes.c_int] * 3 + [fp, i32, fp, ctypes.c_int])
    lib.render_trajectory.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, or None when the numpy path runs (chosen once
    per process; ``reload`` chooses again)."""
    if not _STATE["tried"]:
        with _LOCK:
            if not _STATE["tried"]:
                if os.environ.get("WMZ_DISABLE_NATIVE"):
                    _STATE["failure"] = "WMZ_DISABLE_NATIVE is set"
                else:
                    try:
                        _STATE["lib"] = _build_and_load()
                    except (OSError, subprocess.SubprocessError) as e:
                        err = getattr(e, "stderr", None)
                        _STATE["failure"] = f"{e}" + (
                            f": {err.decode(errors='replace')}" if err else "")
                _STATE["tried"] = True
    return _STATE["lib"]


def reload() -> str:
    """Forget the choice and choose again (reads ``WMZ_DISABLE_NATIVE``
    anew); returns ``backend()``."""
    with _LOCK:
        _STATE.update(tried=False, lib=None, failure=None)
    return backend()


def backend() -> str:
    """``"compiled"`` when the entry points run the built library,
    ``"numpy"`` when they run their numpy path."""
    return "compiled" if get_lib() is not None else "numpy"


def failure() -> Optional[str]:
    """Why the numpy path runs (None when the compiled one does)."""
    get_lib()
    return _STATE["failure"]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check(ok: bool, what: str) -> None:
    """The library reads and writes through raw pointers: refuse arrays of
    another layout before it does."""
    if not ok:
        raise ValueError(what)


def composite_sprite(frames: np.ndarray, sprite: np.ndarray, pos_yx: np.ndarray) -> None:
    """frames (T, H, W) f32 += sprite (K, K) at per-frame top-left (y, x)
    positions (T, 2), clipped to the canvas."""
    lib = get_lib()
    t, h, w = frames.shape
    k = sprite.shape[0]
    if lib is not None:
        _check(frames.flags.c_contiguous and frames.dtype == np.float32,
               "frames must be a C-contiguous float32 (T, H, W) array")
        _check(sprite.shape == (k, k) and np.shape(pos_yx) == (t, 2),
               f"sprite {sprite.shape} must be (K, K), pos_yx {np.shape(pos_yx)} ({t}, 2)")
        lib.composite_sprite(
            _ptr(frames, ctypes.c_float), t, h, w,
            _ptr(np.ascontiguousarray(sprite, np.float32), ctypes.c_float), k,
            _ptr(np.ascontiguousarray(pos_yx, np.int32), ctypes.c_int32))
        return
    for i in range(t):
        sy, sx = int(pos_yx[i, 0]), int(pos_yx[i, 1])
        y0, y1 = max(0, sy), min(h, sy + k)
        x0, x1 = max(0, sx), min(w, sx + k)
        if y1 <= y0 or x1 <= x0:
            continue
        frames[i, y0:y1, x0:x1] += sprite[y0 - sy: y1 - sy, x0 - sx: x1 - sx]


def clamp01(frames: np.ndarray) -> None:
    """Clamp f32 ``frames`` to [0, 1] in place."""
    lib = get_lib()
    if lib is not None and frames.flags.c_contiguous and frames.dtype == np.float32:
        lib.clamp01(_ptr(frames, ctypes.c_float), frames.size)
    else:
        np.clip(frames, 0.0, 1.0, out=frames)


def render_trajectory(out: np.ndarray, bg: np.ndarray, shifts: np.ndarray,
                      rects: np.ndarray) -> None:
    """out (T, H, W, 3) uint8 <- the background scrolled by ``shifts[t]``
    (bg is (H, 2W, 3) f32), clipped to [0, 255] and truncated, with the
    rectangles ``rects[t, i] = (y0, x0, size, r, g, b)`` painted over it."""
    lib = get_lib()
    t, h, w, _ = out.shape
    n = rects.shape[1]
    if lib is not None:
        _check(out.flags.c_contiguous and out.dtype == np.uint8 and out.shape[3] == 3,
               "out must be a C-contiguous uint8 (T, H, W, 3) array")
        _check(bg.shape == (h, 2 * w, 3) and np.shape(shifts) == (t,)
               and rects.shape == (t, n, 6),
               f"bg {bg.shape}, shifts {np.shape(shifts)}, rects {rects.shape} do not "
               f"match out {out.shape}")
        lib.render_trajectory(
            _ptr(out, ctypes.c_uint8), t, h, w,
            _ptr(np.ascontiguousarray(bg, np.float32), ctypes.c_float),
            _ptr(np.ascontiguousarray(shifts, np.int32), ctypes.c_int32),
            _ptr(np.ascontiguousarray(rects, np.float32), ctypes.c_float), n)
        return
    for i in range(t):
        shift = int(shifts[i]) % w
        frame = np.clip(bg[:, shift: shift + w], 0, 255).astype(np.uint8)
        for r in rects[i]:
            y0, x0, k = int(r[0]), int(r[1]), int(r[2])
            y0c, y1c = max(0, y0), min(h, y0 + k)
            x0c, x1c = max(0, x0), min(w, x0 + k)
            frame[y0c:y1c, x0c:x1c] = r[3:6].astype(np.uint8)
        out[i] = frame
