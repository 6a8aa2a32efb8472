"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` into an object file (one
``nvcc`` per source, all started together), and the objects are linked
into one shared library with a plain C interface under ``build/kernels/``
at the repository root. The library's name carries a hash of the sources,
the ``csrc/*.cuh`` headers they include and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded
as it is. Nothing is built when a module is imported: the first kernel
launch (or an explicit ``load_library()``) builds. A failed build raises.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else. ``kernels_launched`` says which
kernels a call launched, from the library's own launch log. ``on_cpu``, ``stream`` and ``check``
are the wrappers' shared plumbing: the CPU-or-one-CUDA-device rule, the
stream to launch on, and the launch status check.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

LAUNCHES: "collections.Counter[str]" = collections.Counter()
# launches the library's launch log names (csrc/launch_log.cu kLogged)
LOGGED = 256

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the build did: seconds, library path, compiler output (ptxas -v)
BUILD_INFO: Dict[str, object] = {}

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, B, S, H, W, heads, dh, es, eh, ew, divide_after, dtype,
    # stream
    "wmz_local3d_fwd": ([_VP] * 4 + [_INT] * 11 + [_VP], _INT),
    # q, k, v, g, dq, lse, delta, B, S, H, W, heads, dh, es, eh, ew, dtype,
    # stream
    "wmz_local3d_bwd_dq": ([_VP] * 7 + [_INT] * 10 + [_VP], _INT),
    # q, k, v, g, lse, delta, dk, dv, B, S, H, W, heads, dh, es, eh, ew,
    # partial_rows, dtype, stream
    "wmz_local3d_bwd_dkv": ([_VP] * 8 + [_INT] * 11 + [_VP], _INT),
    # x, q_in, wk, wv, bv, wq, wo, bo, out, qkv, attn, B, S, H, W, heads,
    # dh, dim, dim_q, out_dim, es, eh, ew, dtype, stream
    "wmz_local3d_block": ([_VP] * 11 + [_INT] * 13 + [_VP], _INT),
    # B, S, H, W, heads, dh, dim, dim_q, out_dim, es, eh, ew, dtype, threads
    # (int out) -> the cooperative grid wmz_local3d_block launches (blocks)
    "wmz_local3d_block_grid": ([_INT] * 13 + [ctypes.POINTER(_INT)], _INT),
    # N, K, train -> bytes of scratch of wmz_vq_encode / wmz_vq_train_stats
    "wmz_vq_scratch_bytes": ([_INT] * 3, ctypes.c_longlong),
    # x, codebook, scratch, idx, N, K, D, x_dtype, stream
    "wmz_vq_encode": ([_VP] * 4 + [_INT] * 4 + [_VP], _INT),
    # x, codebook, scratch, idx, q, cnt, err, dw, N, K, D, stream
    "wmz_vq_train_stats": ([_VP] * 8 + [_INT] * 3 + [_VP], _INT),
    # q, k, v, out, lse, strides (int64 [9]: b, h, n of q, k, v), B, H, N,
    # D, scale, key block, normalise, dtype, stream
    "wmz_flash_fwd": ([_VP] * 6 + [_INT] * 4 + [_FLOAT] + [_INT] * 3 + [_VP], _INT),
    # q, k, v, o, g, lse, dq, delta, strides (int64 [15]: q, k, v, o, g),
    # B, H, N, D, scale, dtype, stream
    "wmz_flash_bwd_dq": ([_VP] * 9 + [_INT] * 4 + [_FLOAT, _INT, _VP], _INT),
    # q, k, v, g, lse, delta, dk, dv, strides (int64 [12]: q, k, v, g),
    # B, H, N, D, scale, dtype, stream
    "wmz_flash_bwd_dkv": ([_VP] * 9 + [_INT] * 4 + [_FLOAT, _INT, _VP], _INT),
    # q, k, v, out, lse, strides (int64 [9]), B, H, group, N, D, block,
    # scale, stream
    "wmz_bdflash_fwd": ([_VP] * 6 + [_INT] * 6 + [_FLOAT, _VP], _INT),
    # q, k, v, o, g, lse, dq, delta, strides (int64 [15]), B, H, group, N,
    # D, block, scale, stream
    "wmz_bdflash_bwd_dq": ([_VP] * 9 + [_INT] * 6 + [_FLOAT, _VP], _INT),
    # q, k, v, g, lse, delta, dk, dv, strides (int64 [12]), B, Hkv, group,
    # N, D, block, scale, stream
    "wmz_bdflash_bwd_dkv": ([_VP] * 9 + [_INT] * 6 + [_FLOAT, _VP], _INT),
    # a, b, c, aux, offsets, E, rows_max, N, K, b_stride, inter, mode,
    # stream
    "wmz_expert_gemm": ([_VP] * 5 + [_INT] * 4 + [ctypes.c_longlong] + [_INT] * 2 + [_VP],
                        _INT),
    # a, b, c, offsets, E, M, N, stream
    "wmz_expert_gemm_wgrad": ([_VP] * 4 + [_INT] * 3 + [_VP], _INT),
    # a, y, b, w, offsets, out, dw, E, T, k, D, mode, stream
    "wmz_expert_rows": ([_VP] * 7 + [_INT] * 5 + [_VP], _INT),
    # xs, ws, bs, ys (arrays of count pointers), ns (count ints), count, M,
    # K, epi, r, stream
    "wmz_dense_tf32": ([ctypes.POINTER(_VP)] * 4 + [ctypes.POINTER(_INT)] + [_INT] * 4
                       + [_VP, _VP], _INT),
    # M, K, column tiles, out (int [6]) -> the plan of a launch
    "wmz_dense_tf32_plan": ([_INT] * 3 + [ctypes.POINTER(_INT)], _INT),
    "wmz_cuda_error_string": ([_INT], ctypes.c_char_p),
    "wmz_launch_log_reset": ([], None),
    # buf, its bytes -> launches since the reset (-1: a name not read)
    "wmz_launch_log": ([ctypes.POINTER(ctypes.c_char), _INT], _INT),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found on PATH or at /usr/local/cuda/bin; the port's CUDA "
        "kernels are built from csrc/ with nvcc on first use"
    )


def _sources() -> List[str]:
    srcs = sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs: List[str]) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    )
    for path in srcs + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands in parallel; raise with the compiler output of the
    first that fails; return the joined output of all."""
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        for cmd in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"CUDA kernel build failed ({p.returncode}): "
                f"{' '.join(cmd)}\n{out}"
            )
    return "".join(outs)


def _build(lib_path: str, srcs: List[str]) -> str:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [
            os.path.join(tmp, os.path.basename(s)[:-3] + ".o") for s in srcs
        ]
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", obj]
            for src, obj in zip(srcs, objs)
        ])
        tmp_lib = os.path.join(tmp, os.path.basename(lib_path))
        log += _run_all([[nvcc, "-shared", *objs, "-o", tmp_lib]])
        os.replace(tmp_lib, lib_path)  # atomic: never a half-written .so
    return log


def load_library() -> ctypes.CDLL:
    """Build (once per source digest) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        srcs = _sources()
        lib_path = os.path.join(BUILD_DIR, f"libwmz_kernels_{_digest(srcs)}.so")
        log = ""
        built = not os.path.exists(lib_path)
        if built:
            log = _build(lib_path, srcs)
        lib = ctypes.CDLL(lib_path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        BUILD_INFO.update(
            seconds=time.perf_counter() - t0, path=lib_path, built=built,
            log=log,
        )
        _lib = lib
        return lib


def kernels_launched(fn) -> List[str]:
    """The kernels one call of ``fn`` launches through the library, in
    order, by demangled name (``void (anonymous namespace)::name<args>(
    params)``): which kernel each C entry picked, as the entries note it
    in the launch log (``csrc/launch_log.cu``), with no profiler. The log
    is the process's, so launches from other threads show too; it names
    the first ``LOGGED`` launches."""
    lib = load_library()
    lib.wmz_launch_log_reset()
    fn()
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib.wmz_launch_log(buf, len(buf))
    if n < 0:
        raise RuntimeError("the launch log could not name a kernel")
    return buf.value.decode().splitlines()


def on_cpu(what: str, *tensors) -> bool:
    """True when every operand lies on the CPU (the wrapper takes its plain
    version); False when all share one CUDA device (it launches its
    kernel); raises otherwise. ``what`` names the operands in the error."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(
            f"{what} operands must share one CUDA device (or all lie on the "
            f"CPU), got {sorted(map(str, devices))}")
    return False


def stream(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(status: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if status != 0:
        msg = load_library().wmz_cuda_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({msg})")
