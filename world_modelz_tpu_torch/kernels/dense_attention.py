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


# ----------------------------------------------------------------------
# Block-diffusion GQA attention: the `bdflash_*` kernels of
# csrc/flash_fwd.cu and csrc/flash_bwd.cu (mask predicate and tile walk in
# csrc/bd_mask.cuh), for SDAR's block-diffusion training
# (``models/sdar.py``). q is (B, Hq, N, D), k and v (B, Hkv, N, D) with Hq a
# multiple of Hkv (query head h reads KV head h // (Hq / Hkv)); the N = 2 L
# positions are [x_t ; x_0] cut into blocks of ``block``. The kernels take
# bf16 at D = 128 with L % 64 == 0 and 64 % block == 0; a CPU tensor takes
# the plain versions below, which evaluate the same predicate over every
# pair.

BD_HEAD_SIZE = 128


def bd_allowed(i: torch.Tensor, j: torch.Tensor, n: int, block: int) -> torch.Tensor:
    """Whether query position ``i`` may see key position ``j`` of [x_t ;
    x_0] (``n`` = 2 L positions): a noisy query its own block and the clean
    blocks before it, a clean query the clean blocks up to its own
    (csrc/bd_mask.cuh:allowed)."""
    half = n // 2
    qn, kn = i < half, j < half
    bi, bj = (i % half) // block, (j % half) // block
    return torch.where(qn, torch.where(kn, bi == bj, bj < bi), ~kn & (bj <= bi))


def bd_mask(n: int, block: int, device=None) -> torch.Tensor:
    """The (n, n) boolean mask of ``bd_allowed`` (query rows)."""
    pos = torch.arange(n, device=device)
    return bd_allowed(pos[:, None], pos[None, :], n, block)


def _bd_check(q, k, v=None):
    if q.dim() != 4 or k.dim() != 4 or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"expected (B, Hq, N, D) q and (B, Hkv, N, D) k, v with Hkv "
                         f"dividing Hq, got {tuple(q.shape)}, {tuple(k.shape)}")
    if (k.shape[0], k.shape[2], k.shape[3]) != (q.shape[0], q.shape[2], q.shape[3]) or (
            v is not None and v.shape != k.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{None if v is None else tuple(v.shape)} disagree")
    if q.shape[2] % 2:
        raise ValueError(f"[x_t ; x_0] has an even length, got {q.shape[2]}")


def _bd_kernel_args(operands, block, stats=()):
    q = operands[0]
    if any(t.dtype != torch.bfloat16 for t in operands):
        raise TypeError("the block-diffusion kernels take bfloat16 operands, got "
                        f"{[t.dtype for t in operands]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in stats):
        raise TypeError("block-diffusion lse and delta must be contiguous float32")
    b, h, n, d = q.shape
    if d != BD_HEAD_SIZE or n % 128 or block < 1 or 64 % block:
        raise ValueError(f"the block-diffusion kernels take D = {BD_HEAD_SIZE}, L a multiple "
                         f"of 64 and a block dividing 64; got D {d}, N {n}, block {block}")
    if not all(kernel_layout(t) for t in operands):
        raise ValueError("block-diffusion kernels need 16-byte rows and strides; got "
                         f"{[t.stride() for t in operands]}")
    strides = [s for t in operands for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(strides))(*strides), b, h, n, d


def _expand(t: torch.Tensor, group: int) -> torch.Tensor:
    return t.repeat_interleave(group, dim=1) if group > 1 else t


def _bd_scores(q, k, block, scale):
    """Masked, scaled f32 scores (B, Hq, N, N) of the plain versions."""
    s = torch.matmul(q.float(), _expand(k, q.shape[1] // k.shape[1]).float().transpose(-1, -2))
    s = s * scale
    return s.masked_fill(~bd_mask(q.shape[2], block, q.device), float("-inf"))


def bd_attention_fwd_plain(q, k, v, block: int, scale: float):
    """The plain forward: (out (B, Hq, N, D) in q's dtype, lse (B, Hq, N) f32),
    P rounded to the operands' dtype before P V as the kernel rounds it."""
    s = _bd_scores(q, k, block, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(q.dtype).float()
    out = torch.matmul(p, _expand(v, q.shape[1] // v.shape[1]).float())
    return out.to(q.dtype), lse


def bd_bwd_dq_plain(q, k, v, o, g, lse, block: int, scale: float):
    """The plain pass 1: (dq, delta), dS rounded to the operands' dtype."""
    group = q.shape[1] // k.shape[1]
    delta = (g.float() * o.float()).sum(-1)
    p = torch.exp(_bd_scores(q, k, block, scale) - lse[..., None])
    dp = torch.matmul(g.float(), _expand(v, group).float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    return torch.matmul(ds, _expand(k, group).float()).to(q.dtype), delta


def bd_bwd_dkv_plain(q, k, v, g, lse, delta, block: int, scale: float):
    """The plain pass 2: (dk, dv) summed over each KV head's query heads,
    P and dS rounded to the operands' dtype."""
    b, h, n, d = q.shape
    group = h // k.shape[1]
    p = torch.exp(_bd_scores(q, k, block, scale) - lse[..., None])
    dp = torch.matmul(g.float(), _expand(v, group).float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), g.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    fold = (b, k.shape[1], group, n, d)
    return dk.reshape(fold).sum(2).to(k.dtype), dv.reshape(fold).sum(2).to(v.dtype)


def bd_attention_fwd(q, k, v, block: int, scale: float):
    """softmax(scale q k^T) v under the block-diffusion mask, and each
    query's log-sum-exp: ``bdflash_fwd_kernel`` on CUDA (out a (B, Hq, N,
    D) view of a (B, N, Hq, D) buffer), the plain version on the CPU."""
    _bd_check(q, k, v)
    if on_cpu("block-diffusion attention", q, k, v):
        return bd_attention_fwd_plain(q, k, v, block, scale)
    strides, b, h, n, d = _bd_kernel_args((q, k, v), block)
    out = _bnhd_empty(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    LAUNCHES["bdflash_fwd"] += 1
    status = load_library().wmz_bdflash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), strides,
        b, h, h // k.shape[1], n, d, block, scale, stream(q))
    check(status, "bdflash_fwd")
    return out, lse


def bd_bwd_dq(q, k, v, o, g, lse, block: int, scale: float):
    """Pass 1 of the block-diffusion backward: (dq, delta)."""
    _bd_check(q, k, v)
    _check_shapes(q, o, g)
    _check_stats(q, lse)
    if on_cpu("block-diffusion attention", q, k, v, o, g, lse):
        return bd_bwd_dq_plain(q, k, v, o, g, lse, block, scale)
    strides, b, h, n, d = _bd_kernel_args((q, k, v, o, g), block, (lse,))
    dq = _bnhd_empty(q)
    delta = torch.empty_like(lse)
    LAUNCHES["bdflash_bwd_dq"] += 1
    status = load_library().wmz_bdflash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), delta.data_ptr(), strides, b, h, h // k.shape[1], n, d, block, scale,
        stream(q))
    check(status, "bdflash_bwd_dq")
    return dq, delta


def bd_bwd_dkv(q, k, v, g, lse, delta, block: int, scale: float):
    """Pass 2 of the block-diffusion backward: (dk, dv), each KV head's
    sum over its query heads."""
    _bd_check(q, k, v)
    _check_shapes(q, g)
    _check_stats(q, lse, delta)
    if on_cpu("block-diffusion attention", q, k, v, g, lse, delta):
        return bd_bwd_dkv_plain(q, k, v, g, lse, delta, block, scale)
    strides, b, h, n, d = _bd_kernel_args((q, k, v, g), block, (lse, delta))
    hk = k.shape[1]
    dk, dv = _bnhd_empty(k), _bnhd_empty(v)
    LAUNCHES["bdflash_bwd_dkv"] += 1
    status = load_library().wmz_bdflash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides, b, hk, h // hk, n, d, block,
        scale, stream(q))
    check(status, "bdflash_bwd_dkv")
    return dk, dv


class BdAttentionFunction(torch.autograd.Function):
    """``bd_attention_fwd`` forward, ``bd_bwd_dq`` then ``bd_bwd_dkv``
    backward. Saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, block, scale):
        out, lse = bd_attention_fwd(q, k, v, block, scale)
        ctx.block, ctx.scale = block, scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype)
        if g.is_cuda and not kernel_layout(g):
            g = g.transpose(1, 2).contiguous().transpose(1, 2)
        dq, delta = bd_bwd_dq(q, k, v, out, g, lse, ctx.block, ctx.scale)
        dk, dv = bd_bwd_dkv(q, k, v, g, lse, delta, ctx.block, ctx.scale)
        return dq, dk, dv, None, None


def bd_attention(q, k, v, block: int, scale: float) -> torch.Tensor:
    """Differentiable block-diffusion GQA attention (the kernels on CUDA,
    the plain versions on the CPU)."""
    return BdAttentionFunction.apply(q, k, v, int(block), float(scale))
