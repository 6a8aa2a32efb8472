"""Local-3D attention: the CUDA kernels ``csrc/local3d_fwd.cu`` (forward)
and ``csrc/local3d_bwd.cu`` (the split backward pair), their wrappers, and
the autograd Function that joins them.

Counterpart of ``world_modelz_tpu.kernels.local3d.local3d_attention_pallas``
and its custom_vjp. A CUDA tensor launches a kernel; a CPU tensor takes the
plain version of the same function in ``models.attention``
(``local3d_attention_rounded``, ``local3d_attention_bwd_dq``,
``local3d_attention_bwd_dkv``).

The forward rounds P to the operand dtype where the TPU kernel that
``_route_fwd`` picks for the shape rounds it: the all-frames kernel rounds
exp(s - m) and divides by the sum after P V, the per-frame and H-tiled
kernels normalise first. ``divides_after_product`` is the port's copy of
that choice. Which CUDA kernel runs is the C entries' choice alone, by
dtype and head size: the tensor cores for bf16 at head sizes 64 and 128,
the CUDA cores otherwise (in bf16 rounding P and dS at the same points).

The backward rounds P and dS to the operand dtype before their products,
as every TPU backward does, and sums dK and dV where the TPU backward that
``_route_bwd`` picks for the shape sums them: once in f32 (the all-frames
and split kernels), or per query frame (the per-frame kernel) or per
query frame and H tile (the H-tiled kernel), each partial rounded to the
operand dtype before the f32 fold. ``bwd_route`` is the port's copy of
that choice; the plain dK/dV pass and the kernel wrapper each take its
``partial_rows``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from world_modelz_tpu_torch.kernels._build import (
    LAUNCHES,
    check,
    load_library,
    on_cpu,
    stream,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Extents = Tuple[int, int, int]

# The JAX package's VMEM budget and unroll cap for its all-frames kernels
# (world_modelz_tpu/kernels/local3d.py: _VMEM_BUDGET_BYTES,
# _MAX_ALLFRAMES_TILES), which decide where its forward rounds P.
_VMEM_BUDGET_BYTES = 10 * 1024 * 1024
_MAX_ALLFRAMES_TILES = 32

# bwd_route's kinds: the TPU backward that ``_route_bwd`` picks
BWD_ALLFRAMES = "allframes"  # _bwd_impl_allframes: dK, dV one f32 sum
BWD_PER_FRAME = "per_frame"  # _bwd_impl: a rounded partial per query frame
BWD_SPLIT = "split"  # _bwd_impl_split: dK, dV one f32 sum
BWD_TILED = "tiled"  # _bwd_impl_tiled: a partial per query frame and H tile
BWD_NONE = "none"  # no TPU kernel takes the shape: summed as the split pair


def _band_candidates(height: int, width: int, eh: int, min_m: int = 128):
    """The JAX package's ``_band_candidates``: query row bands in its
    order of preference, the unbanded frame last."""
    return [
        qt for qt in (2, 4, 8, 16, 32, 64)
        if qt + 2 * eh < height and height % qt == 0 and qt * width >= min_m
    ] + [height]


def _fits_allframes(seq: int, height: int, width: int, extents: Extents,
                    dh: int, itemsize: int, qt: int) -> bool:
    """The JAX package's ``fits_vmem_allframes``: q, out, the padded k and
    v, and one query band's two f32 score intermediates."""
    es, eh, _ = extents
    hw = height * width
    rows_k = (2 * es + 1) * min(height, qt + 2 * eh) * width
    qkv = (seq * hw * dh + 2 * (seq + 2 * es) * hw * dh) * itemsize
    out = seq * hw * dh * itemsize
    score = qt * width * rows_k * 4 * 2
    return qkv + out + score <= _VMEM_BUDGET_BYTES


@functools.lru_cache(maxsize=None)
def allframes_band(seq: int, height: int, width: int, extents: Extents,
                   dh: int, itemsize: int) -> Optional[int]:
    """The JAX package's forward ``pick_allframes_band`` (``bwd=False``):
    the query row band of its all-frames kernel, or None when the shape
    goes to the per-frame or H-tiled kernel."""
    for qt in _band_candidates(height, width, extents[1], min_m=64):
        if seq * -(-height // qt) > _MAX_ALLFRAMES_TILES:
            continue
        if _fits_allframes(seq, height, width, extents, dh, itemsize, qt):
            return qt
    return None


def _fits_allframes_bwd(seq: int, height: int, width: int,
                        extents: Extents, dh: int, itemsize: int,
                        qt: int) -> bool:
    """The JAX package's ``fits_vmem_allframes_bwd``."""
    es, eh, _ = extents
    hw = height * width
    band = min(height, qt + 2 * eh)
    rows_k = (2 * es + 1) * band * width
    per_clip = seq * hw * dh * itemsize
    per_pad = (seq + 2 * es) * hw * dh * itemsize
    per_pad_acc = (seq + 2 * es) * hw * dh * 4
    score = qt * width * rows_k * 4
    score_lo = qt * width * rows_k * itemsize
    dkv_f = (2 * es + 1) * band * width * dh * 4
    return (3 * per_clip + 2 * per_pad + 2 * per_pad_acc + 4 * score
            + 2 * score_lo + 2 * dkv_f <= _VMEM_BUDGET_BYTES)


def _fits_frame_bwd(height: int, width: int, extents: Extents, dh: int,
                    qt: int, itemsize: int) -> bool:
    """The JAX package's ``fits_vmem(..., bwd=True)``."""
    es, eh, _ = extents
    hw = height * width
    ts = 2 * es + 1
    rows_q = qt * width
    rows_k = ts * min(height, qt + 2 * eh) * width
    score = rows_q * rows_k * 4 * 2
    total = score + ts * hw * dh * itemsize * 2 + hw * dh * itemsize * 2
    total += (hw * dh * itemsize * 2 + ts * hw * dh * 4 * 2
              + ts * hw * dh * itemsize * 2 + score
              + rows_q * rows_k * itemsize * 2)
    return total <= _VMEM_BUDGET_BYTES


def _fits_split_dq(height: int, width: int, extents: Extents, dh: int,
                   itemsize: int, qt: int) -> bool:
    """The JAX package's ``_fits_split_dq``."""
    es, eh, _ = extents
    hw = height * width
    ts = 2 * es + 1
    rows_q = qt * width
    rows_k = ts * min(height, qt + 2 * eh) * width
    return (rows_q * rows_k * (4 * 4 + itemsize) + 2 * ts * hw * dh * itemsize
            + 3 * hw * dh * itemsize + 2 * hw * 4 <= _VMEM_BUDGET_BYTES)


def _fits_split_dkv(height: int, width: int, extents: Extents, dh: int,
                    itemsize: int, kt: int) -> bool:
    """The JAX package's ``_fits_split_dkv``."""
    es, eh, _ = extents
    hw = height * width
    ts = 2 * es + 1
    rows_p = (height + 2 * eh) * width
    rows_k, cols_q = kt * width, (kt + 2 * eh) * width
    return (rows_k * cols_q * (4 * 4 + 2 * itemsize)
            + 2 * ts * rows_p * dh * itemsize + 2 * ts * rows_p * 4
            + 4 * hw * dh * itemsize + 2 * rows_k * dh * 4
            <= _VMEM_BUDGET_BYTES)


def _h_tile(height: int, width: int, extents: Extents, dh: int):
    """The JAX package's ``pick_h_tile``: the H-tiled kernel's query row
    tile, or None."""
    es, eh, _ = extents
    ts = 2 * es + 1
    for th in (4, 8, 16, 32):
        if th < 2 * eh or th >= height or height % th:
            continue
        rows_q, rows_k = th * width, ts * 2 * th * width
        if (rows_q * rows_k * 4 * 2 + rows_k * dh * 16 + rows_q * dh * 16
                <= _VMEM_BUDGET_BYTES):
            return th
    return None


class BwdRoute(NamedTuple):
    """The TPU backward for a shape, and where it rounds dK and dV:
    ``partial_rows`` query rows of a frame per rounded partial (the frame
    height for the per-frame kernel, the H tile for the H-tiled one), or 0
    where dK and dV are one f32 sum, rounded once."""

    kind: str
    partial_rows: int


def bwd_route(shape, heads: int, extents: Extents,
              dtype: torch.dtype) -> BwdRoute:
    """The port's copy of ``_route_bwd`` for q's (B, S, H, W, heads * dh)
    ``shape``: the all-frames kernel where ``pick_allframes_band(bwd=True)``
    finds a band, else the per-frame kernel (``pick_frame_band(bwd=True)``),
    the split pair (``pick_split_bands``) or the H-tiled kernel
    (``pick_h_tile``); ``BWD_NONE`` where the JAX package raises. Cached:
    every backward call asks."""
    _, s, h, w, inner = shape
    return _bwd_route(s, h, w, tuple(int(e) for e in extents), inner // heads,
                      torch.empty((), dtype=dtype).element_size())


@functools.lru_cache(maxsize=None)
def _bwd_route(s: int, h: int, w: int, ext: Extents, dh: int,
               item: int) -> BwdRoute:
    cands = _band_candidates(h, w, ext[1])
    for qt in cands:
        if (s * -(-h // qt) <= _MAX_ALLFRAMES_TILES
                and _fits_allframes_bwd(s, h, w, ext, dh, item, qt)):
            return BwdRoute(BWD_ALLFRAMES, 0)
    if any(_fits_frame_bwd(h, w, ext, dh, qt, item) for qt in cands):
        return BwdRoute(BWD_PER_FRAME, h)
    if (any(_fits_split_dq(h, w, ext, dh, item, qt) for qt in cands)
            and any(_fits_split_dkv(h, w, ext, dh, item, kt) for kt in cands)):
        return BwdRoute(BWD_SPLIT, 0)
    th = _h_tile(h, w, ext, dh)
    if th is not None:
        return BwdRoute(BWD_TILED, th)
    return BwdRoute(BWD_NONE, 0)


def divides_after_product(shape, heads: int, extents: Extents,
                          dtype: torch.dtype) -> bool:
    """Whether the TPU forward that ``_route_fwd`` picks for q's (B, S, H,
    W, heads * dh) ``shape`` rounds P unnormalised and divides P V by the
    sum (``_attn_kernel_allframes``); False where it normalises P before
    rounding it (``_attn_kernel``, ``_attn_kernel_tiled``, and shapes no
    TPU kernel takes)."""
    _, s, h, w, inner = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    return allframes_band(s, h, w, tuple(extents), inner // heads,
                          itemsize) is not None


def _check_layout(q: torch.Tensor, heads: int, *same: torch.Tensor) -> None:
    """q and every tensor of ``same`` are (B, S, H, W, heads * dim_head) of
    one shape."""
    if q.dim() != 5 or any(t.shape != q.shape for t in same):
        raise ValueError(
            f"expected operands of one (B, S, H, W, inner) shape, got "
            f"{[tuple(t.shape) for t in (q, *same)]}"
        )
    if q.shape[-1] % heads:
        raise ValueError(
            f"inner width {q.shape[-1]} not divisible by heads={heads}")


def _kernel_args(extents: Extents, heads: int, tensors, stats=()):
    """Checks what the CUDA kernels take; returns (B, S, H, W, heads, dh,
    es, eh, ew, dtype code)."""
    q = tensors[0]
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(
            f"local3d kernels take float32 or bfloat16 operands of one "
            f"dtype, got {[t.dtype for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in stats):
        raise TypeError("local3d lse and delta must be float32")
    b, s, h, w, inner = q.shape
    dh = inner // heads
    if dh % 32 or dh > 256:
        raise ValueError(
            f"local3d kernels need dim_head % 32 == 0 and <= 256, got {dh}"
        )
    es, eh, ew = (int(e) for e in extents)
    if min(es, eh, ew) < 0:
        raise ValueError(f"extents must be >= 0, got {extents}")
    every = (*tensors, *stats)
    if not all(t.is_contiguous() for t in every):
        raise ValueError("local3d kernels need contiguous operands")
    if any(t.data_ptr() % 16 for t in every):
        raise ValueError("local3d kernels need 16-byte aligned operands")
    return b, s, h, w, heads, dh, es, eh, ew, _DTYPES[q.dtype]


def local3d_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    extents: Extents,
    heads: int,
    divide_after: Optional[bool] = None,
) -> torch.Tensor:
    """Windowed space-time attention; same contract as the plain version,
    ``local3d_attention_rounded``. ``divide_after`` None rounds P where
    ``divides_after_product`` says for the shape; True or False holds it
    to that rounding point (the sequence-parallel path's halo-padded
    shards round where the JAX package's sequence path rounds).

    Args:
      q, k, v: (B, S, H, W, heads * dim_head), float32 or bfloat16.
      extents: (e_s, e_h, e_w) half-widths of the window.
      heads: number of heads.

    Returns:
      (B, S, H, W, heads * dim_head) in the input dtype. No autograd graph
      on CUDA: training goes through ``local3d_attention``.
    """
    _check_layout(q, heads, k, v)
    if divide_after is None:
        divide_after = divides_after_product(q.shape, heads, extents, q.dtype)
    if on_cpu("local3d", q, k, v):
        from world_modelz_tpu_torch.models.attention import local3d_attention_rounded

        return local3d_attention_rounded(q, k, v, extents, heads, divide_after)
    args = _kernel_args(extents, heads, (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = load_library()
    LAUNCHES["local3d_fwd"] += 1
    status = lib.wmz_local3d_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args[:-1],
        int(divide_after), args[-1], stream(q),
    )
    check(status, "local3d_fwd")
    return out


def local3d_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    extents: Extents,
    heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward pass 1: (dq, lse, delta) for the output cotangent ``g``.

    dq is (B, S, H, W, heads * dim_head) in the input dtype; lse (the
    log-sum-exp of each query's scaled scores) and delta (rowsum(dP * P))
    are (B, S, H, W, heads) float32.
    """
    _check_layout(q, heads, k, v, g)
    if on_cpu("local3d", q, k, v, g):
        from world_modelz_tpu_torch.models.attention import local3d_attention_bwd_dq

        return local3d_attention_bwd_dq(q, k, v, g, extents, heads)
    args = _kernel_args(extents, heads, (q, k, v, g))
    dq = torch.empty_like(q)
    lse = torch.empty(q.shape[:4] + (heads,), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    if q.numel() == 0:
        return dq, lse, delta
    lib = load_library()
    LAUNCHES["local3d_bwd_dq"] += 1
    status = lib.wmz_local3d_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *args, stream(q),
    )
    check(status, "local3d_bwd_dq")
    return dq, lse, delta


def local3d_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    extents: Extents,
    heads: int,
    partial_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass 2: (dk, dv) from pass 1's lse and delta, in the input
    dtype, summed where ``bwd_route`` says the TPU backward for the shape
    sums them (or in partials of ``partial_rows`` query rows when given, 0
    one sum)."""
    _check_layout(q, heads, k, v, g)
    stat_shape = q.shape[:4] + (heads,)
    if lse.shape != stat_shape or delta.shape != stat_shape:
        raise ValueError(
            f"lse and delta must be {tuple(stat_shape)}, got "
            f"{tuple(lse.shape)} and {tuple(delta.shape)}"
        )
    if partial_rows is None:
        partial_rows = bwd_route(q.shape, heads, extents, q.dtype).partial_rows
    if on_cpu("local3d", q, k, v, g, lse, delta):
        from world_modelz_tpu_torch.models.attention import _local3d_bwd_dkv

        return _local3d_bwd_dkv(q, k, v, g, lse, delta, extents, heads, partial_rows)
    args = _kernel_args(extents, heads, (q, k, v, g), (lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    lib = load_library()
    LAUNCHES["local3d_bwd_dkv"] += 1
    status = lib.wmz_local3d_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *args[:-1], partial_rows, args[-1], stream(q),
    )
    check(status, "local3d_bwd_dkv")
    return dk, dv


class Local3dAttentionFunction(torch.autograd.Function):
    """Forward kernel, and the split backward pair as its gradient; the
    counterpart of the custom_vjp of ``local3d_attention_pallas``. Saves
    only q, k and v (the backward recomputes the scores)."""

    @staticmethod
    def forward(ctx, q, k, v, extents, heads, route=None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.extents, ctx.heads = extents, heads
        ctx.route = route or (None, None)
        ctx.save_for_backward(q, k, v)
        return local3d_attention_fwd(q, k, v, extents, heads, ctx.route[0])

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        dq, lse, delta = local3d_bwd_dq(q, k, v, g, ctx.extents, ctx.heads)
        dk, dv = local3d_bwd_dkv(q, k, v, g, lse, delta, ctx.extents,
                                 ctx.heads, ctx.route[1])
        return dq, dk, dv, None, None, None


def local3d_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    extents: Extents,
    heads: int,
    route: Optional[Tuple[bool, int]] = None,
) -> torch.Tensor:
    """Differentiable windowed attention: ``local3d_attention_fwd`` forward,
    ``local3d_bwd_dq`` then ``local3d_bwd_dkv`` backward (the kernels on
    CUDA, their plain versions on the CPU). ``route`` (divide_after,
    partial_rows) fixes the rounding points that the shape would pick."""
    return Local3dAttentionFunction.apply(q, k, v, tuple(extents), heads, route)
