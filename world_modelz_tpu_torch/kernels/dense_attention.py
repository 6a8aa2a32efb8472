"""Dense flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward)
and ``csrc/flash_bwd.cu`` (the split backward pair), their wrappers, and
the autograd Function that joins them.

Counterpart of the stock Pallas TPU ``flash_attention`` that
``world_modelz_tpu.models.attention._flash_dense_attention`` calls. A CUDA
tensor launches a kernel; a CPU tensor takes the plain version of the same
function in ``models.attention`` (``dense_attention_fwd``,
``dense_attention_bwd_dq``, ``dense_attention_bwd_dkv``).

Operands are (B, H, N, D) with D = 64 or 128, float32 or bfloat16. The
kernels read any layout whose last dimension is contiguous and whose other
strides are whole 16-byte chunks (``kernel_layout``), so q, k and v may be
the strided head views of a fused QKV projection. The bfloat16 kernels run
on the tensor cores and round P (forward and dV) and dS to bfloat16 before
their products, as the stock TPU kernels do; the forward rounds P against
the running max of each key block of ``flash_block_size`` keys, the stock
forward's blocking. The float32 forward runs on the tensor cores too, in
split TF32: each operand x as hi = tf32(x) plus lo = tf32(x - hi), each
product as lo hi + hi lo + hi hi summed in f32, which keeps f32 accuracy
whatever ``torch.backends.cuda.matmul.allow_tf32`` says; the float32
backward pair keeps f32 FMAs on the CUDA cores. Every
output (out, dq, dk, dv) is a (B, H, N, D) view of a (B, N, H,
D)-contiguous buffer, so that merging the heads back into (B, N, H * D)
copies nothing.
lse and delta are (B, H, N) float32.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from world_modelz_tpu_torch.kernels._build import (
    LAUNCHES,
    check,
    load_library,
    on_cpu,
    stream,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (64, 128)


def flash_block_size(n: int) -> Tuple[int, int]:
    """(key block, padded length) of the stock TPU forward for ``n`` tokens,
    as the JAX package's ``_flash_dense_attention`` picks them: n padded to
    a multiple of 128, and the largest of 512, 256 and 128 that divides it.
    The forward rounds P against the running max of each such block; a
    single block (padded length <= 512 and a power-of-two multiple of 128)
    is normalised before it is rounded."""
    padded = n + (-n % 128)
    return max(b for b in (512, 256, 128) if padded % b == 0), padded


def _check_shapes(q: torch.Tensor, *same: torch.Tensor) -> None:
    if q.dim() != 4 or any(t.shape != q.shape for t in same):
        raise ValueError(
            f"expected (B, H, N, D) operands of one shape, got "
            f"{[tuple(t.shape) for t in (q, *same)]}")


def _check_stats(q: torch.Tensor, *stats: torch.Tensor) -> None:
    if any(t.shape != q.shape[:3] for t in stats):
        raise ValueError(
            f"lse and delta must be {tuple(q.shape[:3])}, got "
            f"{[tuple(t.shape) for t in stats]}")


def kernel_layout(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` in place with 16-byte loads: last
    dimension contiguous, 16-byte aligned base, the b, h and n strides
    multiples of 16 bytes (4 float32 or 8 bfloat16 elements)."""
    return (t.stride(-1) == 1
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _kernel_args(operands, stats=()):
    """Checks what the CUDA kernels take; returns (strides array, B, H, N,
    D, dtype code)."""
    q = operands[0]
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in operands):
        raise TypeError(
            f"flash attention kernels take float32 or bfloat16 operands of "
            f"one dtype, got {[t.dtype for t in operands]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in stats):
        raise TypeError("flash attention lse and delta must be contiguous float32")
    b, h, n, d = q.shape
    if d not in HEAD_SIZES:
        raise ValueError(
            f"flash attention kernels take head sizes {HEAD_SIZES}, got {d}")
    if not all(kernel_layout(t) for t in operands):
        raise ValueError(
            "flash attention kernels need operands whose last dimension is "
            "contiguous, 16-byte aligned, with the other strides multiples "
            f"of 16 bytes; got strides {[t.stride() for t in operands]}")
    if max(b * h, n) >= 2**31:
        raise ValueError(f"flash attention shape {tuple(q.shape)} too large")
    strides = [s for t in operands for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(strides))(*strides), b, h, n, d, _DTYPES[q.dtype]


def _bnhd_empty(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, N, D) view of a (B, N, H, D) buffer."""
    b, h, n, d = q.shape
    return torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(scale * q k^T) v and each query's log-sum-exp.

    Args:
      q, k, v: (B, H, N, D), float32 or bfloat16.

    Returns:
      out (B, H, N, D) in the input dtype, and lse (B, H, N) float32. No
      autograd graph on CUDA: training goes through ``flash_attention``.
      Both dtypes launch tensor-core kernels.
    """
    _check_shapes(q, k, v)
    if on_cpu("flash attention", q, k, v):
        from world_modelz_tpu_torch.models.attention import dense_attention_fwd

        return dense_attention_fwd(q, k, v, scale)
    strides, b, h, n, d, dtype = _kernel_args((q, k, v))
    out = _bnhd_empty(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    block, padded = flash_block_size(n)
    lib = load_library()
    LAUNCHES["flash_fwd"] += 1
    status = lib.wmz_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), strides, b, h, n, d, scale, block,
        int(block == padded), dtype, stream(q))
    check(status, "flash_fwd")
    return out, lse


def flash_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    g: torch.Tensor,
    lse: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass 1: (dq, delta) for the output ``o`` and its cotangent
    ``g``; delta = rowsum(g * o) is (B, H, N) float32."""
    _check_shapes(q, k, v, o, g)
    _check_stats(q, lse)
    if on_cpu("flash attention", q, k, v, o, g, lse):
        from world_modelz_tpu_torch.models.attention import dense_attention_bwd_dq

        return dense_attention_bwd_dq(q, k, v, o, g, lse, scale)
    strides, b, h, n, d, dtype = _kernel_args((q, k, v, o, g), (lse,))
    dq = _bnhd_empty(q)
    delta = torch.empty_like(lse)
    if q.numel() == 0:
        return dq, delta
    lib = load_library()
    LAUNCHES["flash_bwd_dq"] += 1
    status = lib.wmz_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), strides, b, h, n, d,
        scale, dtype, stream(q))
    check(status, "flash_bwd_dq")
    return dq, delta


def flash_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass 2: (dk, dv) from pass 1's lse and delta, in the input
    dtype."""
    _check_shapes(q, k, v, g)
    _check_stats(q, lse, delta)
    if on_cpu("flash attention", q, k, v, g, lse, delta):
        from world_modelz_tpu_torch.models.attention import dense_attention_bwd_dkv

        return dense_attention_bwd_dkv(q, k, v, g, lse, delta, scale)
    strides, b, h, n, d, dtype = _kernel_args((q, k, v, g), (lse, delta))
    dk, dv = _bnhd_empty(k), _bnhd_empty(v)
    if q.numel() == 0:
        return dk, dv
    lib = load_library()
    LAUNCHES["flash_bwd_dkv"] += 1
    status = lib.wmz_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        strides, b, h, n, d, scale, dtype, stream(q))
    check(status, "flash_bwd_dkv")
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Forward kernel, and the split backward pair as its gradient; the
    counterpart of the custom_vjp of the stock TPU ``flash_attention``.
    Saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype)
        if g.is_cuda and not kernel_layout(g):
            g = g.transpose(1, 2).contiguous().transpose(1, 2)
        dq, delta = flash_bwd_dq(q, k, v, out, g, lse, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Differentiable dense attention: ``flash_attention_fwd`` forward,
    ``flash_bwd_dq`` then ``flash_bwd_dkv`` backward (the kernels on CUDA,
    their plain versions on the CPU)."""
    return FlashAttentionFunction.apply(q, k, v, float(scale))
