"""The whole-block fused local-3D attention: the CUDA kernel
``csrc/local3d_block.cu``, its wrapper, its plain version, the gate that
says which shapes the fused path takes, and the autograd Function.

Counterpart of ``world_modelz_tpu.kernels.local3d_block`` (``local3d_block``
and its custom_vjp). The forward is one kernel: the q, k and v projections,
the windowed attention and the output projection. The backward has no
kernel of its own, as in the JAX package: it rebuilds the unfused
composition (``dense_apply`` projections around ``kernels.local3d.
local3d_attention``, whose forward and split backward pair are kernels on
CUDA) and differentiates it. A CUDA tensor launches the kernel; a CPU
tensor takes ``local3d_block_reference``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from world_modelz_tpu_torch.kernels import local3d as local3d_kernels
from world_modelz_tpu_torch.kernels._build import (
    LAUNCHES,
    check,
    load_library,
    on_cpu,
    stream,
)
from world_modelz_tpu_torch.ops.dense import dense_apply

Extents = Tuple[int, int, int]

# the gate's budget: the JAX package's per-program VMEM budget for the
# fused block (kernels/local3d_block.py:62), kept so that the port takes
# exactly the shapes the JAX package takes
_BLOCK_VMEM_BUDGET_BYTES = 12 * 1024 * 1024


def _band_candidates(height: int, width: int, eh: int, min_m: int = 128):
    """The query row bands the JAX package's local-3D kernels consider,
    narrowest first, then the whole frame (kernels/local3d.py:102)."""
    return [
        qt for qt in (2, 4, 8, 16, 32, 64)
        if qt + 2 * eh < height and height % qt == 0 and qt * width >= min_m
    ] + [height]


def fits_vmem_block(
    seq: int,
    height: int,
    width: int,
    extents: Extents,
    heads: int,
    dh: int,
    dim: int,
    out_dim: int,
    itemsize: int = 2,
) -> bool:
    """Whether the JAX package's fused-block program for one clip fits its
    working-set budget (kernels/local3d_block.py:65-101): the two input
    clips, the padded k/v and q projections, one banded query tile's f32
    scores, the attention output, the output clip and the four weights."""
    hw = height * width
    es, eh = extents[0], extents[1]
    ts = 2 * es + 1
    inner = heads * dh
    clips_in = 2 * seq * hw * dim * itemsize
    proj = (2 * (seq + 2 * es) + seq) * hw * inner * itemsize
    qt = next((c for c in _band_candidates(height, width, eh) if c < height),
              height)
    band = min(height, qt + 2 * eh)
    score = qt * width * ts * band * width * 4 * 2
    staging = seq * hw * inner * itemsize
    out = seq * hw * out_dim * itemsize
    weights = (3 * dim * inner + inner * out_dim) * itemsize
    total = clips_in + proj + score + staging + out + weights
    return total <= _BLOCK_VMEM_BUDGET_BYTES


def block_supported(
    seq: int,
    height: int,
    width: int,
    extents: Extents,
    heads: int,
    dh: int,
    dim: int,
    out_dim: int,
    itemsize: int = 2,
) -> bool:
    """The fused path's gate, as the JAX package's (kernels/local3d_block.py:
    104-119): S * heads <= 64 and ``fits_vmem_block``. ``Local3dAttention``
    applies it; the kernel itself takes any shape its wrapper accepts."""
    return seq * heads <= 64 and fits_vmem_block(
        seq, height, width, extents, heads, dh, dim, out_dim, itemsize
    )


def local3d_block_reference(x_kv, q_in, wk, wv, bv, wq, wo, bo, extents, heads):
    """Plain version of the kernel, with its rounding points: each product
    accumulated in f32 (or wider) and cast to x_kv's dtype; bv added after
    that cast; the attention weights normalised, then cast (the plain
    ``models.attention.local3d_attention``); bo added in f32 before the one
    cast of the output.

    Args:
      x_kv: (B, S, H, W, dim), the normed key/value stream.
      q_in: (B, S, H, W, dim_q), the raw query stream.
      wk, wv: (inner, dim); bv: (inner,); wq: (inner, dim_q); wo: (out_dim,
        inner); bo: (out_dim,) — nn.Linear's (out, in) layout.
      extents: (e_s, e_h, e_w); heads: inner = heads * dim_head.

    Returns:
      (B, S, H, W, out_dim) in x_kv's dtype.
    """
    from world_modelz_tpu_torch.models.attention import _f32, local3d_attention

    dt = x_kv.dtype

    def proj(a, w):
        return (_f32(a) @ _f32(w).T).to(dt)

    k = proj(x_kv, wk)
    v = proj(x_kv, wv) + bv.to(dt)
    q = proj(q_in, wq)
    a = local3d_attention(q, k, v, tuple(extents), heads)
    return (_f32(a) @ _f32(wo).T + _f32(bo)).to(dt)


def _check_shapes(x_kv, q_in, wk, wv, bv, wq, wo, bo, heads) -> None:
    inner = wk.shape[0]
    if x_kv.dim() != 5 or q_in.dim() != 5 or x_kv.shape[:4] != q_in.shape[:4]:
        raise ValueError(
            f"x_kv and q_in must be (B, S, H, W, dim) of one grid, got "
            f"{tuple(x_kv.shape)} and {tuple(q_in.shape)}")
    want = {
        "wk": (wk, (inner, x_kv.shape[-1])),
        "wv": (wv, (inner, x_kv.shape[-1])),
        "bv": (bv, (inner,)),
        "wq": (wq, (inner, q_in.shape[-1])),
        "wo": (wo, (wo.shape[0], inner)),
        "bo": (bo, (wo.shape[0],)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if heads < 1 or inner % heads:
        raise ValueError(f"inner width {inner} not divisible by heads={heads}")


def _kernel_args(extents, heads, ops):
    """Checks what the CUDA kernel takes; returns (B, S, H, W, heads, dh,
    dim, dim_q, out_dim, es, eh, ew, dtype code)."""
    x_kv, q_in, wk, wv, bv, wq, wo, bo = ops
    codes = local3d_kernels._DTYPES  # the dtypes the local-3D kernels take
    if x_kv.dtype not in codes or any(t.dtype != x_kv.dtype for t in ops):
        raise TypeError(
            f"local3d_block takes float32 or bfloat16 operands of one dtype, "
            f"got {[t.dtype for t in ops]}")
    b, s, h, w, dim = x_kv.shape
    dim_q, inner, out_dim = q_in.shape[-1], wk.shape[0], wo.shape[0]
    dh = inner // heads
    if dh % 32 or dh > 256:
        raise ValueError(
            f"local3d_block needs dim_head % 32 == 0 and <= 256, got {dh}")
    if dim % 4 or dim_q % 4 or out_dim % 4:
        raise ValueError(
            f"local3d_block needs dim, dim_q and out_dim % 4 == 0, got "
            f"{dim}, {dim_q}, {out_dim}")
    es, eh, ew = (int(e) for e in extents)
    if min(es, eh, ew) < 0:
        raise ValueError(f"extents must be >= 0, got {extents}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("local3d_block needs contiguous operands")
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("local3d_block needs 16-byte aligned operands")
    if b * s * h * w * max(dim, dim_q, 3 * inner, out_dim) >= 2**31:
        raise ValueError("local3d_block indexes rows with 32-bit ints")
    return (b, s, h, w, heads, dh, dim, dim_q, out_dim, es, eh, ew,
            codes[x_kv.dtype])


def local3d_block_fwd(x_kv, q_in, wk, wv, bv, wq, wo, bo,
                      extents: Extents, heads: int) -> torch.Tensor:
    """The fused block, forward only; same contract as
    ``local3d_block_reference``. A CUDA tensor launches
    ``wmz_local3d_block`` (no autograd graph: training goes through
    ``local3d_block``); a CPU tensor takes the plain version."""
    ops = (x_kv, q_in, wk, wv, bv, wq, wo, bo)
    _check_shapes(*ops, heads)
    if on_cpu("local3d_block", *ops):
        return local3d_block_reference(*ops, extents, heads)
    args = _kernel_args(extents, heads, ops)
    b, s, h, w = x_kv.shape[:4]
    rows, inner = b * s * h * w, wk.shape[0]
    out = torch.empty((b, s, h, w, wo.shape[0]), dtype=x_kv.dtype,
                      device=x_kv.device)
    if rows == 0:
        return out
    # scratch: the projections [q | k | v] and the attention output
    qkv = torch.empty((rows, 3 * inner), dtype=x_kv.dtype, device=x_kv.device)
    attn = torch.empty((rows, inner), dtype=x_kv.dtype, device=x_kv.device)
    lib = load_library()
    LAUNCHES["local3d_block"] += 1
    status = lib.wmz_local3d_block(
        *(t.data_ptr() for t in ops), out.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), *args, stream(x_kv),
    )
    check(status, "local3d_block")
    return out


def block_composition(x_kv, q_in, wk, wv, bv, wq, wo, bo, extents, heads):
    """The unfused block: ``dense_apply`` projections (the bias after the
    rounded product) around the differentiable ``kernels.local3d.
    local3d_attention`` (JAX's ``_block_pallas_composition``); what the
    fused backward rebuilds."""
    k = dense_apply(x_kv, wk)
    v = dense_apply(x_kv, wv, bv)
    q = dense_apply(q_in, wq)
    out = local3d_kernels.local3d_attention(q, k, v, extents, heads)
    return dense_apply(out, wo, bo)


class Local3dBlockFunction(torch.autograd.Function):
    """The fused kernel as forward; the backward rematerializes
    ``block_composition`` and differentiates it, with the cotangent cast to
    x_kv's dtype (JAX's ``_block_vjp_bwd``). Saves only the eight inputs."""

    @staticmethod
    def forward(ctx, x_kv, q_in, wk, wv, bv, wq, wo, bo, extents, heads):
        ops = tuple(t.contiguous() for t in (x_kv, q_in, wk, wv, bv, wq, wo, bo))
        ctx.extents, ctx.heads = extents, heads
        ctx.save_for_backward(*ops)
        return local3d_block_fwd(*ops, extents, heads)

    @staticmethod
    def backward(ctx, g):
        ops = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = block_composition(*ops, ctx.extents, ctx.heads)
            grads = torch.autograd.grad(out, ops, g.to(ops[0].dtype))
        return (*grads, None, None)


def local3d_block(x_kv, q_in, wk, wv, bv, wq, wo, bo,
                  extents: Extents, heads: int) -> torch.Tensor:
    """Differentiable fused block: out = (attn(q_in wq^T, x_kv wk^T,
    x_kv wv^T + bv)) wo^T + bo, weights in nn.Linear's (out, in) layout;
    (B, S, H, W, dim) in, (B, S, H, W, out_dim) out, in x_kv's dtype."""
    return Local3dBlockFunction.apply(
        x_kv, q_in, wk, wv, bv, wq, wo, bo, tuple(extents), heads)
