"""Dense layers in f32 on the tensor cores: the split-TF32 GEMM
``csrc/dense_tf32.cu`` with the bias, a tanh GELU or a residual add in its
epilogue, its wrapper and its plain version.

``dense_tf32(x, weight, bias, gelu=, residual=)`` is ``epi(x W^T + b)``
for one layer; ``dense_tf32_group`` takes up to three layers that share
their rows and depth (the attention's q, k and v projections) in one
launch. The kernel replaces no TPU kernel: the JAX package leaves dense
layers to XLA. ``ops.dense.tf32_route`` says where the models take it.

``dense_tf32_reference`` is the plain version of the same arithmetic: each
operand split into hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna``: to
nearest, ties away from zero), each 8-deep step's three TF32 products lo_x
hi_w + hi_x lo_w + hi_x hi_w, each 32-deep chunk's twelve summed apart and
added to the running sum in f32, in chunk order; then the bias, then the
GELU or the residual. A CUDA tensor launches the kernel; a CPU tensor takes
the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from world_modelz_tpu_torch.kernels._build import (
    LAUNCHES,
    check,
    load_library,
    on_cpu,
    stream,
)

MAX_PROBLEMS = 3  # layers of one launch (csrc/dense_tf32.cu kMaxProblems)
STEP = 8  # depth of a TF32 product (wgmma m64nNk8); K must be a multiple
CHUNK = 32  # depth whose products the kernel sums apart, then adds in f32
TILE = 64  # output columns of a kernel tile
_EPILOGUES = {"none": 0, "gelu": 1, "residual": 2}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32``: the magnitude to
    10 mantissa bits, ties away from zero, the low 13 bits cleared (on the
    int32 view, so +-inf and NaN are kept as they are)."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def dense_tf32_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    gelu: bool = False,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version: ``epi(x W^T + b)`` in split TF32, step by step as
    the kernel sums (module docstring)."""
    k = x.shape[-1]
    (xh, xl), (wh, wl) = split(x.reshape(-1, k)), split(weight)
    s = torch.zeros((xh.shape[0], weight.shape[0]), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, CHUNK):
        t = None
        for k1 in range(k0, min(k0 + CHUNK, k), STEP):
            c = slice(k1, k1 + STEP)
            for a, b in ((xl, wh), (xh, wl), (xh, wh)):
                p = a[:, c] @ b[:, c].T
                t = p if t is None else t + p
        s = s + t
    y = s.reshape(*x.shape[:-1], weight.shape[0])
    if bias is not None:
        y = y + bias
    if gelu:
        y = F.gelu(y, approximate="tanh")
    if residual is not None:
        y = y + residual
    return y


def _check(x: torch.Tensor, weight: torch.Tensor, bias, what: str) -> None:
    """Raise unless x (..., K), weight (N, K) and bias (N,) are contiguous
    f32 tensors with K a multiple of 8 that the kernel indexes in int32."""
    tensors = [x, weight] + ([] if bias is None else [bias])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} takes float32 operands, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if weight.dim() != 2 or x.dim() < 1 or x.shape[-1] != weight.shape[1]:
        raise ValueError(f"{what}: expected x (..., K) and weight (N, K), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"{what}: bias {tuple(bias.shape)} is not ({weight.shape[0]},)")
    k = weight.shape[1]
    if k == 0 or k % STEP:
        raise ValueError(f"{what} needs a depth K that is a positive multiple of "
                         f"{STEP}, got {k}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous operands")
    if x.numel() // k >= 2**31 or weight.numel() >= 2**31:
        raise ValueError(f"{what} indexes rows with int32, got x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}")


def _launch(problems, epi: str = "none", residual=None) -> List[torch.Tensor]:
    """One kernel launch over ``problems`` ((x, weight, bias) on one CUDA
    device, sharing rows and depth); returns their outputs."""
    x0 = problems[0][0]
    k = x0.shape[-1]
    rows = x0.numel() // k
    outs = [torch.empty((*x.shape[:-1], w.shape[0]), dtype=torch.float32, device=x.device)
            for x, w, _ in problems]
    if rows == 0:
        return outs
    ptrs = [t.data_ptr() for x, w, b in problems for t in (x, w) + (() if b is None else (b,))]
    if residual is not None:
        ptrs.append(residual.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("dense_tf32 needs 16-byte aligned operands")
    n = len(problems)
    arr = ctypes.c_void_p * n
    lib = load_library()
    LAUNCHES["dense_tf32"] += 1
    status = lib.wmz_dense_tf32(
        arr(*(x.data_ptr() for x, _, _ in problems)),
        arr(*(w.data_ptr() for _, w, _ in problems)),
        arr(*(None if b is None else b.data_ptr() for _, _, b in problems)),
        arr(*(y.data_ptr() for y in outs)),
        (ctypes.c_int * n)(*(w.shape[0] for _, w, _ in problems)),
        n, rows, k, _EPILOGUES[epi], None if residual is None else residual.data_ptr(),
        stream(x0),
    )
    check(status, "dense_tf32")
    return outs


def dense_tf32(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    gelu: bool = False,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One dense layer, ``epi(x W^T + b)`` in split TF32.

    Args:
      x: (..., K) float32, K a multiple of 8.
      weight: (N, K) float32, nn.Linear's layout.
      bias: (N,) float32 or None, added to the f32 sum.
      gelu: the tanh GELU after the bias.
      residual: (..., N) float32 added after the bias (not with ``gelu``).

    Returns:
      (..., N) float32.
    """
    if gelu and residual is not None:
        raise ValueError("dense_tf32 takes the GELU or the residual, not both")
    _check(x, weight, bias, "dense_tf32")
    want = (*x.shape[:-1], weight.shape[0])
    if residual is not None and (residual.dtype != torch.float32 or tuple(residual.shape) != want
                                 or not residual.is_contiguous()):
        raise ValueError(f"dense_tf32: the residual must be a contiguous float32 {want}, got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    operands = [x, weight] + [t for t in (bias, residual) if t is not None]
    if on_cpu("dense_tf32", *operands):
        return dense_tf32_reference(x, weight, bias, gelu=gelu, residual=residual)
    epi = "gelu" if gelu else "none" if residual is None else "residual"
    return _launch([(x, weight, bias)], epi, residual)[0]


def dense_tf32_group(
    problems: Sequence[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]],
) -> List[torch.Tensor]:
    """Up to three dense layers ``x_i W_i^T + b_i`` (no epilogue) whose
    inputs share their shape, in one launch: each (x, weight, bias) as
    ``dense_tf32`` takes it. Returns the outputs in order."""
    if not 1 <= len(problems) <= MAX_PROBLEMS:
        raise ValueError(f"dense_tf32_group takes 1 to {MAX_PROBLEMS} layers, "
                         f"got {len(problems)}")
    for x, w, b in problems:
        _check(x, w, b, "dense_tf32_group")
        if x.shape != problems[0][0].shape:
            raise ValueError(f"dense_tf32_group: inputs of shapes {tuple(problems[0][0].shape)} "
                             f"and {tuple(x.shape)}")
    operands = [t for p in problems for t in p if t is not None]
    if on_cpu("dense_tf32_group", *operands):
        return [dense_tf32_reference(x, w, b) for x, w, b in problems]
    return _launch(list(problems))


def dense_tf32_plan(rows: int, k: int, widths: Sequence[int]) -> Dict[str, int]:
    """The kernel's plan on the current CUDA device for ``rows`` rows of
    depth ``k`` and layers of output widths ``widths``: row tiles, depth
    chunks, chunks a split, splits, CTAs, and the clusters of that many
    splits resident at once."""
    out = (ctypes.c_int * 6)()
    n_tiles = sum(-(-n // TILE) for n in widths)
    check(load_library().wmz_dense_tf32_plan(rows, k, n_tiles, out), "dense_tf32 plan")
    return dict(zip(("m_tiles", "chunks", "per_split", "splits", "ctas", "clusters"), out))
