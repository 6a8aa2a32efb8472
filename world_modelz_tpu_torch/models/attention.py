"""Transformer backbones: NÜWA-style local 3D attention and the dense
pre-norm transformer.

Port of ``world_modelz_tpu.models.attention`` (reference:
vq-video-diffusion/local_3d_attention.py:34-163): every (s, h, w) token of a
(B, S, H, W) token grid attends to its (2e_s+1)(2e_h+1)(2e_w+1) space-time
neighbourhood, with border masking and factorized learned s/h/w position
embeddings.

The dense stack (reference: minecraft/transformer.py:34-80) is
``DenseAttention`` / ``DenseTransformer``: fused QKV, per-head scaled
dot-product over all N tokens, and FFNs that are either ``FeedForward`` or
the mixture of experts ``MoEFeedForward`` (``parallel/moe.py``). ``dense_attention`` is the JAX package's
``backend="xla"`` branch; ``dense_attention_fwd``,
``dense_attention_bwd_dq`` and ``dense_attention_bwd_dkv`` are the plain
versions of the three flash-attention kernels of
``kernels/dense_attention.py`` (forward with its log-sum-exp, and the split
backward pair).

``local3d_attention`` is the JAX package's XLA route, written as it writes
it: keys and values stacked for the 2e_s+1 frame offsets, dense per-frame
scores, and an additive -1e9 mask for pairs outside the spatial window or
off the clip. ``local3d_attention_rounded`` is the plain version of the
CUDA forward kernel (``kernels/local3d.py``): the same scores, with P
rounded to the operand dtype where the TPU kernel for the shape rounds it.
``local3d_attention_bwd_dq`` and ``local3d_attention_bwd_dkv`` are the
plain versions of the two backward kernels, written as the JAX package's
split backward (``_bwd_impl_split``) computes: scores, P and dP in f32 (or
wider), with P and dS rounded to the operand dtype before their products
and dK, dV summed where the TPU backward for the shape sums them
(``kernels.local3d.bwd_route``). CPU tensors and the tests
use them; ``Local3dAttention`` goes through the autograd Function of
``kernels/local3d.py``, which on CUDA launches the kernels and on the CPU
calls the last three; with ``backend="fused"`` it runs the whole block
through ``kernels/local3d_block.py`` instead. Submodule names follow the reference
state_dict layout (``transformer.layers.{i}.0.fn.to_q`` ...), so the weight
bridge (``convert.py``) loads with ``strict=True``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from world_modelz_tpu_torch.kernels import dense_attention as dense_kernels
from world_modelz_tpu_torch.kernels import local3d as local3d_kernels
from world_modelz_tpu_torch.kernels.dense_tf32 import dense_tf32, dense_tf32_group
from world_modelz_tpu_torch.kernels.local3d_block import (
    block_supported,
    local3d_block,
)
from world_modelz_tpu_torch.ops.dense import dense_apply, narrow, tf32_route
from world_modelz_tpu_torch.parallel import moe
from world_modelz_tpu_torch.parallel.distributed import copy_to, gather_from, reduce_from

NEG_INF = -1e9  # reference mask value (local_3d_attention.py:92)
# DenseAttention's "auto" backend takes the flash kernel from this many
# tokens on (models/attention.py:200-205 of the JAX package)
FLASH_MIN_TOKENS = 1024


class Dense(nn.Linear):
    """``nn.Linear``'s parameters and state_dict, applied as flax's
    ``nn.Dense`` (``dense_apply``): every biased dense layer of the port."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_apply(x, self.weight, self.bias)


def _as_f32(*tensors):
    return [None if t is None else t.to(torch.float32) for t in tensors]


def dense_layer(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor = None, *,
                gelu: bool = False, dropout: nn.Dropout = None, residual: torch.Tensor = None,
                attached: bool = False) -> torch.Tensor:
    """A dense layer and what follows it in the module: the tanh GELU
    (``gelu``), ``dropout``, then a residual add (``residual``). Where
    ``ops.dense.tf32_route`` takes it (an f32 forward without autograd on
    the card; ``attached``: the calling module has a model axis) and the
    dropout passes its input through, one launch of the split-TF32 kernel
    with the bias, the GELU or the residual in its epilogue; else
    ``dense_apply``, then the GELU, the dropout and the add as their own
    ops."""
    passes = dropout is None or not dropout.training or dropout.p == 0.0
    if passes and tf32_route(x, weight, attached):
        x, weight, bias, residual = _as_f32(x, weight, bias, residual)
        return dense_tf32(x, weight, bias, gelu=gelu, residual=residual)
    y = dense_apply(x, weight, bias)
    if gelu:
        y = F.gelu(y, approximate="tanh")
    if dropout is not None:
        y = dropout(y)
    return _plus(y, residual)


def _plus(y: torch.Tensor, residual) -> torch.Tensor:
    return y if residual is None else y + residual


class _EmbeddingFunction(torch.autograd.Function):
    """``F.embedding`` whose weight gradient is one_hot(indices)^T @ grad, a
    GEMM, so every run sums a row's contributions in the same order."""

    @staticmethod
    def forward(ctx, indices, weight):
        ctx.save_for_backward(indices)
        ctx.rows = weight.shape[0]
        return F.embedding(indices, weight)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        flat = indices.reshape(-1, 1)
        g = g.reshape(-1, g.shape[-1])
        onehot = torch.zeros((flat.shape[0], ctx.rows), dtype=g.dtype, device=g.device)
        onehot.scatter_(1, flat, 1.0)
        return None, onehot.t() @ g


class Embedding(nn.Embedding):
    """``nn.Embedding``'s parameters and state_dict, with a weight gradient
    that is the same on every run: PyTorch's CUDA embedding backward adds
    the rows of repeated indices with atomics (two f32 backward passes of
    24,576 indices into 513 rows differed in every row used, torch 2.11 on
    an H100), which would make two runs of a train step differ in their
    last bits. The gradient is a one-hot product instead
    (``_EmbeddingFunction``); the values are the same sums."""

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        return _EmbeddingFunction.apply(indices, self.weight)


def _col_bias(bias: torch.Tensor, width: int, tp) -> torch.Tensor:
    """This model rank's ``width`` entries of a replicated column-parallel
    bias (JAX keeps those biases whole), its gradient summed over ``tp``."""
    return copy_to(bias, tp)[tp.index * width:(tp.index + 1) * width]


def _row_parallel(x: torch.Tensor, weight: torch.Tensor, bias, tp) -> torch.Tensor:
    """A row-parallel Dense: this rank's partial product (in f32 or wider,
    so bf16 operands round once, after the sum), summed over ``tp``, then
    the bias added once, as ``dense_apply`` adds it."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    wide = torch.promote_types(dt, torch.float32)
    y = reduce_from(F.linear(x.to(wide), weight.to(wide)), tp).to(dt)
    return y if bias is None else y + bias.to(dt)


class FeedForward(nn.Module):
    """Dense -> GELU (tanh approximation, flax's ``nn.gelu``) -> Dense
    (transformer.py:20-31). Under tensor parallelism (``tp``, set by
    ``parallel.mesh.shard_params``) the first Dense is column-parallel and
    the second row-parallel, one all-reduce. ``forward(x, residual)``
    returns the output plus ``residual`` (the block's skip): where
    ``dense_layer`` takes the split-TF32 kernel, the first Dense carries
    the GELU and the second the residual in their epilogues."""

    tp_params = ("net.0.weight", "net.3.weight")

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            Dense(dim, hidden_dim),
            nn.GELU(approximate="tanh"),
            nn.Dropout(dropout),
            Dense(hidden_dim, dim),
            nn.Dropout(dropout),
        )
        self.tp = None

    def forward(self, x: torch.Tensor, residual: torch.Tensor = None) -> torch.Tensor:
        tp = self.tp
        up, act, drop, down, drop_out = self.net
        if tp is None:
            h = dense_layer(x, up.weight, up.bias, gelu=True, dropout=drop)
            return dense_layer(h, down.weight, down.bias, dropout=drop_out, residual=residual)
        h = dense_apply(copy_to(x, tp), up.weight,
                        _col_bias(up.bias, up.weight.shape[0], tp))
        return _plus(drop_out(_row_parallel(drop(act(h)), down.weight, down.bias, tp)),
                     residual)


class MoEFeedForward(nn.Module):
    """Top-1 routed mixture-of-experts FFN, a drop-in for ``FeedForward``
    (JAX's ``MoEFeedForward``, models/attention.py:63): the parameters
    ``w_gate`` (dim, E), ``w_in`` (E, dim, hidden), ``b_in`` (E, hidden),
    ``w_out`` (E, hidden, dim), ``b_out`` (E, dim) in flax's layout and
    init, cast to the input's dtype at each call, and
    max(1, ceil(capacity_factor * N / E)) slots per expert. ``forward``
    returns (y, the load-balance loss), the loss JAX sows as ``moe_aux``.
    ``impl``: ``"dispatch"`` the main path (``parallel.moe.
    moe_ffn_indexed``, equal to JAX's dispatch einsums ``moe_ffn``),
    ``"reference"`` every token through its own expert (``moe_reference``,
    no capacity). No dropout, as in JAX. ``mesh`` (set by the trainers,
    ``parallel.mesh.attach``): the load-balance term's batch means are the
    global batch's over its data axis. ``global_aux`` False (a caller that
    drops the term, such as sampling) keeps them this rank's, so no
    collective runs and one rank may sample alone (the trainers' evaluation
    on rank 0). Under expert sharding (``tp``, set by ``parallel.mesh.
    shard_params`` where the model axis divides E; ``impl="dispatch"``
    only) each model rank holds E / n_model experts and
    ``moe_ffn_indexed`` combines their outputs with one all-reduce."""

    tp_params = ("w_in", "w_out", "b_in", "b_out")

    def __init__(self, dim: int, hidden_dim: int, num_experts: int,
                 capacity_factor: float = 1.25, impl: str = "dispatch"):
        super().__init__()
        if impl not in ("dispatch", "reference"):
            raise ValueError(f"impl must be 'dispatch' or 'reference', got {impl!r}")
        self.num_experts, self.capacity_factor, self.impl = (
            num_experts, capacity_factor, impl)
        e, hid = num_experts, hidden_dim
        self.w_gate = nn.Parameter(torch.randn(dim, e) * dim**-0.5)
        self.w_in = nn.Parameter(torch.randn(e, dim, hid) * dim**-0.5)
        self.b_in = nn.Parameter(torch.zeros(e, hid))
        self.w_out = nn.Parameter(torch.randn(e, hid, dim) * hid**-0.5)
        self.b_out = nn.Parameter(torch.zeros(e, dim))
        self.mesh = None
        self.tp = None

    def tp_supported(self, n: int) -> bool:
        return self.impl == "dispatch"

    def forward(self, x: torch.Tensor,
                global_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        p = moe.MoEParams(*(w.to(x.dtype) for w in (
            self.w_gate, self.w_in, self.b_in, self.w_out, self.b_out)))
        mesh = self.mesh if global_aux else None
        if self.impl == "reference":
            gate, expert = moe.route(p, x)
            return moe.moe_reference(p, x), moe.load_balance_loss(gate, expert, mesh)
        capacity = moe.moe_capacity(self.capacity_factor, x.shape[1], self.num_experts)
        sharded = {} if self.tp is None else {"tp": self.tp}
        return moe.moe_ffn_indexed(p, x, capacity=capacity, mesh=mesh, **sharded)


@functools.lru_cache(maxsize=16)
def _window_mask_np(
    seq: int, height: int, width: int, extents: Tuple[int, int, int]
) -> np.ndarray:
    """(S, HW, Ts, HW) bool: True where the key lies outside the query's
    spatial window or its frame offset falls off the clip."""
    es, eh, ew = extents
    hq = np.arange(height)[:, None, None, None]
    wq = np.arange(width)[None, :, None, None]
    hk = np.arange(height)[None, None, :, None]
    wk = np.arange(width)[None, None, None, :]
    inside = (np.abs(hq - hk) <= eh) & (np.abs(wq - wk) <= ew)
    spatial = (~inside).reshape(height * width, height * width)
    s = np.arange(seq)[:, None]
    ds = np.arange(-es, es + 1)[None, :]
    temporal = ~((s + ds >= 0) & (s + ds < seq))  # (S, Ts)
    return spatial[None, :, None, :] | temporal[:, None, :, None]


def local3d_attention_weights_mask(
    seq: int, height: int, width: int, extents: Tuple[int, int, int],
    device: torch.device,
) -> torch.Tensor:
    """(S, HW, Ts, HW) additive f32 mask (0 or NEG_INF)."""
    masked = _window_mask_np(seq, height, width, tuple(extents))
    return torch.where(
        torch.from_numpy(masked).to(device), NEG_INF, 0.0
    ).to(torch.float32)


def _shift_stack_frames(t: torch.Tensor, es: int) -> torch.Tensor:
    """(Z, S, HW, D) -> (Z, S, Ts, HW, D) with out[:, s, i] = t[:, s + ds_i],
    zero off the ends of the clip (those keys are masked), also where the
    offset reaches past the whole clip (es >= S)."""
    seq = t.shape[1]
    stacks = []
    for ds in range(-es, es + 1):
        shifted = torch.zeros_like(t)
        if abs(ds) >= seq:
            pass
        elif ds < 0:
            shifted[:, -ds:] = t[:, : seq + ds]
        elif ds > 0:
            shifted[:, : seq - ds] = t[:, ds:]
        else:
            shifted = t
        stacks.append(shifted)
    return torch.stack(stacks, dim=2)


def _to_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H, W, heads * d) -> (B * heads, S, H * W, d); d is 1 for the
    (B, S, H, W, heads) stat tensors."""
    b, s, h, w, inner = t.shape
    d = inner // heads
    t = t.reshape(b, s, h * w, heads, d).permute(0, 3, 1, 2, 4)
    return t.reshape(b * heads, s, h * w, d)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """At least float32: bf16 is widened, float64 (gradcheck) kept."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and widened back: an operand cast."""
    return t.to(dtype).to(t.dtype)


def _from_heads(t: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of ``_to_heads`` for the (B, S, H, W, heads * d) ``shape``."""
    b, s, h, w, inner = shape
    heads = t.shape[0] // b
    return (
        t.reshape(b, heads, s, h * w, -1)
        .permute(0, 2, 3, 1, 4)
        .reshape(b, s, h, w, inner)
    )


def local3d_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    extents: Tuple[int, int, int],
    heads: int,
) -> torch.Tensor:
    """Windowed space-time attention core (plain version).

    Args:
      q, k, v: (B, S, H, W, heads * dim_head).
      extents: (e_s, e_h, e_w) neighbourhood half-widths.
      heads: number of attention heads.

    Returns:
      (B, S, H, W, heads * dim_head) in v's dtype. Scores and softmax in f32.
    """
    es = extents[0]
    b, s, h, w, inner = q.shape
    dh = inner // heads
    hw = h * w
    ts = 2 * es + 1

    qh = _to_heads(q, heads)
    kh = _shift_stack_frames(_to_heads(k, heads), es)  # (Z, S, Ts, HW, dh)
    vh = _shift_stack_frames(_to_heads(v, heads), es)

    scale = dh**-0.5
    scores = torch.einsum("zsqd,zstkd->zsqtk", _f32(qh), _f32(kh)) * scale
    scores = scores + local3d_attention_weights_mask(s, h, w, extents, q.device)
    attn = torch.softmax(
        scores.reshape(b * heads, s, hw, ts * hw), dim=-1
    ).reshape(scores.shape)
    out = torch.einsum("zsqtk,zstkd->zsqd", attn.to(vh.dtype), vh)
    return _from_heads(out, q.shape)


def local3d_attention_rounded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    extents: Tuple[int, int, int],
    heads: int,
    divide_after: bool,
) -> torch.Tensor:
    """Plain version of the forward kernel: the window's f32 scores and
    P = exp(s - m), m the max over the query's whole window, rounded to
    the operand dtype where the TPU kernel rounds it, and P V summed in
    f32 (or wider):

      divide_after (``_attn_kernel_allframes``, local3d.py:531-539):
        out = (round(P) V) / l;
      else (``_attn_kernel`` :207-211, ``_attn_kernel_tiled`` :924-928):
        out = round(P / l) V;

    with l the sum of the unrounded P. ``kernels.local3d.
    divides_after_product`` says which the TPU forward takes for a shape.

    Returns:
      (B, S, H, W, heads * dim_head) in q's dtype.
    """
    es = extents[0]
    b, s, h, w, inner = q.shape
    dh = inner // heads
    hw = h * w
    ts = 2 * es + 1
    kh = _shift_stack_frames(_to_heads(k, heads), es)  # (Z, S, Ts, HW, dh)
    vh = _f32(_shift_stack_frames(_to_heads(v, heads), es))
    scores = torch.einsum("zsqd,zstkd->zsqtk", _f32(_to_heads(q, heads)), _f32(kh))
    scores = scores * dh**-0.5
    scores = scores + local3d_attention_weights_mask(s, h, w, extents, q.device)
    flat = scores.reshape(b * heads, s, hw, ts * hw)
    p = torch.exp(flat - flat.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if not divide_after:
        p = p / l
    out = torch.einsum("zsqtk,zstkd->zsqd",
                       _rounded(p, v.dtype).reshape(scores.shape), vh)
    if divide_after:
        out = out / l
    return _from_heads(out, q.shape).to(q.dtype)


def local3d_attention_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    extents: Tuple[int, int, int],
    heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward pass 1 (plain version): query-centric, as the JAX
    package's ``_bwd_kernel_dq``: dense per-frame scores of each query
    against its 2e_s+1 stacked key frames, the additive window mask, then

      lse = m + log l,  delta = rowsum(dP * P),
      dq = (round(P * (dP - delta)) @ K) * scale,

    P = exp(s - m) / l. dS = P * (dP - delta) is rounded to the operand
    dtype before its product, as every TPU backward rounds it
    (world_modelz_tpu/kernels/local3d.py:710, :1054, :1225, :1611); the
    scale follows the product. Rounding to f32 or float64 is the identity.

    Args:
      q, k, v: (B, S, H, W, heads * dim_head); g: the output's cotangent.

    Returns:
      dq in q's dtype; lse and delta (B, S, H, W, heads), float32 (float64
      for float64 inputs). Products and sums in f32 or wider.
    """
    es = extents[0]
    b, s, h, w, inner = q.shape
    dh = inner // heads
    hw = h * w
    ts = 2 * es + 1
    qh = _f32(_to_heads(q, heads))
    gh = _f32(_to_heads(g, heads))
    kh = _shift_stack_frames(_f32(_to_heads(k, heads)), es)
    vh = _shift_stack_frames(_f32(_to_heads(v, heads)), es)

    scale = dh**-0.5
    scores = torch.einsum("zsqd,zstkd->zsqtk", qh, kh) * scale
    scores = scores + local3d_attention_weights_mask(s, h, w, extents, q.device)
    flat = scores.reshape(b * heads, s, hw, ts * hw)
    m = flat.amax(-1, keepdim=True)
    p = torch.exp(flat - m)
    l = p.sum(-1, keepdim=True)
    attn = (p / l).reshape(scores.shape)
    lse = (m + torch.log(l))[..., 0]  # (Z, S, HW)

    dp = torch.einsum("zsqd,zstkd->zsqtk", gh, vh)
    delta = (dp * attn).sum((-2, -1))
    dscores = _rounded(attn * (dp - delta[..., None, None]), q.dtype)
    dq = torch.einsum("zsqtk,zstkd->zsqd", dscores, kh) * scale
    stats = q.shape[:4] + (heads,)
    return (
        _from_heads(dq, q.shape).to(q.dtype),
        _from_heads(lse[..., None], stats),
        _from_heads(delta[..., None], stats),
    )


def local3d_attention_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    extents: Tuple[int, int, int],
    heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass 2 (plain version): key-centric, as the JAX package's
    ``_bwd_kernel_dkv``. The window is symmetric, so the queries that see a
    key of frame f are the window of that key: queries, cotangents and
    their stats are stacked for the 2e_s+1 frame offsets around f, P is
    rebuilt as exp(scores - lse) under the same additive mask, and

      dv = round(P)^T @ G,  dk = (round(P * (G @ V^T - delta))^T @ Q) * scale,

    P and dS rounded to the operand dtype before their products, as every
    TPU backward rounds them (world_modelz_tpu/kernels/local3d.py:709-710,
    :1053-1054, :1301-1308, :1610-1611). The sums are f32 (or wider) and
    end where the TPU backward for the shape ends them: ``partial_rows`` 0
    (the all-frames and split kernels) sums every query of a key's window
    and rounds once; otherwise each query frame's queries of each tile of
    ``partial_rows`` rows (the whole frame for the per-frame kernel's
    slabs, ``_part_dtype`` :49; the H tile for the H-tiled kernel's) form a
    partial that is rounded before the partials are summed (the fold,
    :1688, :1131) and rounded again, as ``kernels.local3d.bwd_route`` says
    for the shape. Rounding to f32 or float64 is the identity, so wider
    inputs keep one sum.

    Args:
      q, k, v, g: (B, S, H, W, heads * dim_head); lse, delta: pass 1's
        (B, S, H, W, heads) float32 stats.

    Returns:
      (dk, dv) in k's and v's dtypes.
    """
    rows = local3d_kernels.bwd_route(q.shape, heads, extents, q.dtype).partial_rows
    return _local3d_bwd_dkv(q, k, v, g, lse, delta, extents, heads, rows)


def _local3d_bwd_dkv(q, k, v, g, lse, delta, extents, heads, partial_rows):
    """``local3d_attention_bwd_dkv`` with dK and dV summed in partials of
    ``partial_rows`` query rows (0: one sum), whatever the shape's route."""
    es = extents[0]
    b, s, h, w, inner = q.shape
    dh = inner // heads
    kh = _f32(_to_heads(k, heads))  # (Z, S, HW, dh): the keys
    vh = _f32(_to_heads(v, heads))
    # queries at frame f + t - es, zero off the clip (those are masked)
    qs = _shift_stack_frames(_f32(_to_heads(q, heads)), es)
    gs = _shift_stack_frames(_f32(_to_heads(g, heads)), es)
    lses = _shift_stack_frames(_to_heads(lse, heads), es)[..., 0]
    deltas = _shift_stack_frames(_to_heads(delta, heads), es)[..., 0]

    scale = dh**-0.5
    # (Z, S, HW keys, Ts, HW queries); the mask is symmetric in (key, query)
    scores = torch.einsum("zfkd,zftqd->zfktq", kh, qs) * scale
    scores = scores + local3d_attention_weights_mask(s, h, w, extents, q.device)
    p = torch.exp(scores - lses[:, :, None])
    dp = torch.einsum("zfkd,zftqd->zfktq", vh, gs)
    dscores = _rounded(p * (dp - deltas[:, :, None]), q.dtype)
    p = _rounded(p, q.dtype)
    if not partial_rows or q.dtype in (torch.float32, torch.float64):
        dv = torch.einsum("zfktq,zftqd->zfkd", p, gs)
        dk = torch.einsum("zfktq,zftqd->zfkd", dscores, qs) * scale
    else:
        # one partial per (query frame t, tile i of partial_rows rows)
        z, ts = p.shape[0], p.shape[3]
        tiles = (z, s, h * w, ts, h // partial_rows, partial_rows * w)
        rows = (z, s, ts, h // partial_rows, partial_rows * w, dh)
        dv_part = torch.einsum("zfktiq,zftiqd->zfktid", p.reshape(tiles),
                               gs.reshape(rows))
        dk_part = torch.einsum("zfktiq,zftiqd->zfktid", dscores.reshape(tiles),
                               qs.reshape(rows)) * scale
        dv = _rounded(dv_part, q.dtype).sum((3, 4))
        dk = _rounded(dk_part, q.dtype).sum((3, 4))
    return (
        _from_heads(dk, k.shape).to(k.dtype),
        _from_heads(dv, v.shape).to(v.dtype),
    )


LOCAL3D_BACKENDS = ("auto", "pallas", "xla", "fused")


class Local3dAttention(nn.Module):
    """QKV projections around the windowed attention core
    (local_3d_attention.py:34-118). ``to_q`` and ``to_k`` have no bias,
    ``to_v`` and ``to_out`` do; ``to_out`` is absent when
    ``heads == 1 and dim_head == dim``. ``backend`` takes the JAX package's
    values, with the GPU in the TPU's place:
    - ``"auto"`` and ``"pallas"``: the projections, then the autograd
      Function ``kernels.local3d.local3d_attention`` (the kernels on CUDA,
      their plain versions on the CPU), so gradients reach ``to_q``,
      ``to_k`` and ``to_v`` on CUDA as on the CPU;
    - ``"xla"``: the plain ``local3d_attention``;
    - ``"fused"``: the whole block in one kernel
      (``kernels.local3d_block.local3d_block``), in the dtype that x and the
      weights promote to; raises ``ValueError`` where the JAX package does
      (no ``to_out``, or a shape ``block_supported`` turns away).
    The parameters and the state_dict are the same for every backend. The
    dropout after ``to_out`` follows ``module.train()``, as flax's
    ``train=True``. ``use_checkpointing`` (JAX's, on by default) recomputes
    the plain attention core (``"xla"``) in the backward pass instead of
    keeping its (B, S, H, W, window) weights, as ``jax.checkpoint`` does
    (local_3d_attention.py:110-113); the kernel routes take no extra
    checkpoint (their backward reruns what it needs), as JAX's Pallas route
    does not.

    Model axes (set by the trainers): ``tp`` (``parallel.mesh.
    shard_params``) holds this rank's rows of ``to_q``, ``to_k``, ``to_v``
    and columns of ``to_out``. Where ``heads`` divides by the axis the
    attention runs on the rank's heads and ``to_out`` is row-parallel (one
    all-reduce, its bias added once); otherwise (e.g. one head of 128)
    q, k and v are gathered whole, every rank runs the whole attention and
    keeps its columns of the output for its part of ``to_out``. With
    ``"fused"`` the block kernel gets the rank's heads, its columns of
    ``to_out`` and the bias on rank 0 alone, or without a head split the
    gathered projections and ``to_out`` zero outside the rank's columns.
    ``seq`` (``parallel.sequence.attach_seq``) shards the frame axis:
    the halo-exchange attention of ``parallel.sequence``, which takes the
    place of any backend, as JAX's ``seq_axis`` does.

    ``forward(x, q, residual)`` returns the block's output plus
    ``residual``. Without a model axis, where ``ops.dense.tf32_route``
    takes the projections (an f32 forward without autograd on the card),
    q (over the un-normed ``q``), k and v (over ``x``, with ``to_v``'s bias)
    are one launch of the split-TF32 kernel, and ``to_out`` carries its
    bias and the residual in its epilogue."""

    tp_params = ("to_q.weight", "to_k.weight", "to_v.weight", "to_out.0.weight")

    def __init__(
        self,
        dim: int,
        extents: Tuple[int, int, int],
        heads: int = 8,
        dim_head: int = 64,
        dropout: float = 0.0,
        backend: str = "auto",
        use_checkpointing: bool = True,
    ):
        super().__init__()
        if backend not in LOCAL3D_BACKENDS:
            raise ValueError(
                f"backend must be one of {LOCAL3D_BACKENDS}, got {backend!r}")
        inner = heads * dim_head
        self.extents = tuple(int(e) for e in extents)
        self.heads, self.dim_head, self.backend = heads, dim_head, backend
        self.use_checkpointing = use_checkpointing
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = Dense(dim, inner)
        self.to_out = None
        if not (heads == 1 and dim_head == dim):
            self.to_out = nn.Sequential(Dense(inner, dim), nn.Dropout(dropout))
        self.tp = None
        self.seq = None

    def tp_supported(self, n: int) -> bool:
        return self.to_out is not None

    def _head_split(self) -> bool:
        return self.tp is not None and self.heads % self.tp.size == 0

    def forward(self, x: torch.Tensor, q: torch.Tensor,
                residual: torch.Tensor = None) -> torch.Tensor:
        """x: normed (B, S, H, W, dim) key/value input; q: query input;
        residual: added to the output."""
        if self.backend == "fused" and self.seq is None:
            return _plus(self._fused(x, q), residual)
        tp, heads = self.tp, self.heads
        attached = tp is not None or self.seq is not None
        wq, wk, wv = self.to_q.weight, self.to_k.weight, self.to_v.weight
        if (q.shape == x.shape and tf32_route(q, wq, attached)
                and tf32_route(x, wk, attached) and tf32_route(x, wv, attached)):
            q, x, wq, wk, wv, bv = _as_f32(q, x, wq, wk, wv, self.to_v.bias)
            qp, k, v = dense_tf32_group([(q, wq, None), (x, wk, None), (x, wv, bv)])
        elif tp is None:
            qp, k, v = self.to_q(q), self.to_k(x), self.to_v(x)
        else:
            x, q = copy_to(x, tp), copy_to(q, tp)
            qp, k = self.to_q(q), self.to_k(x)
            v = dense_apply(x, self.to_v.weight,
                            _col_bias(self.to_v.bias, self.to_v.weight.shape[0], tp))
            if self._head_split():
                heads //= tp.size
            else:
                qp, k, v = (gather_from(t, tp) for t in (qp, k, v))
        if self.seq is not None:
            from world_modelz_tpu_torch.parallel.sequence import seq_sharded_attention

            out = seq_sharded_attention(qp, k, v, self.extents, heads, self.seq)
        elif self.backend != "xla":
            out = local3d_kernels.local3d_attention(qp, k, v, self.extents, heads)
        elif self.use_checkpointing and torch.is_grad_enabled():
            out = torch.utils.checkpoint.checkpoint(
                local3d_attention, qp, k, v, self.extents, heads,
                use_reentrant=False)
        else:
            out = local3d_attention(qp, k, v, self.extents, heads)
        if tp is not None:
            proj = self.to_out[0]
            if not self._head_split():  # this rank's columns of the whole output
                width = proj.weight.shape[1]
                out = out[..., tp.index * width:(tp.index + 1) * width]
            return _plus(self.to_out[1](_row_parallel(out, proj.weight, proj.bias, tp)),
                         residual)
        if self.to_out is None:
            return _plus(out, residual)
        proj, drop = self.to_out
        return dense_layer(out, proj.weight, proj.bias, dropout=drop, residual=residual,
                           attached=attached)

    def _fused_operands(self, x, q, dt):
        """The block kernel's (x, q, wk, wv, bv, wq, wo, bo, heads): the
        module's own, or this model rank's share of them."""
        proj, tp = self.to_out[0], self.tp
        wk, wv, bv, wq = (self.to_k.weight, self.to_v.weight, self.to_v.bias,
                          self.to_q.weight)
        wo, bo, heads = proj.weight, proj.bias, self.heads
        if tp is not None:
            x, q = copy_to(x, tp), copy_to(q, tp)
            # the output bias once across the model group: on rank 0
            bo = copy_to(bo, tp) * (1.0 if tp.index == 0 else 0.0)
            width = wk.shape[0]
            if self._head_split():
                bv = _col_bias(bv, width, tp)
                heads //= tp.size
            else:
                wk, wv, wq = (gather_from(t, tp, dim=0) for t in (wk, wv, wq))
                bv = copy_to(bv, tp)
                inner = wk.shape[0]
                wo = F.pad(wo, (tp.index * width, inner - (tp.index + 1) * width))
        return [t.to(dt) for t in (x, q, wk, wv, bv, wq, wo, bo)] + [heads]

    def _fused(self, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        s, h, w, dim = x.shape[1:]
        dt = torch.promote_types(x.dtype, self.to_k.weight.dtype)
        itemsize = torch.empty((), dtype=dt).element_size()
        heads = self.heads // self.tp.size if self._head_split() else self.heads
        if self.to_out is None or not block_supported(
                s, h, w, self.extents, heads, self.dim_head, dim, dim,
                itemsize):
            raise ValueError(
                f"fused local3d block kernel unsupported for grid {h}x{w} "
                f"S={s} extents {self.extents} dtype "
                f"{str(dt).replace('torch.', '')} (working set exceeds VMEM "
                "or no output projection); use backend='pallas' or 'xla'")
        *operands, heads = self._fused_operands(x, q, dt)
        out = local3d_block(*operands, self.extents, heads)
        if self.tp is not None:
            wide = torch.promote_types(dt, torch.float32)
            out = reduce_from(out.to(wide), self.tp).to(dt)
        return self.to_out[1](out)


class PreNorm(nn.Module):
    """LayerNorm (eps 1e-6, the flax default) before ``fn``. With ``q``
    given, only ``x`` is normed and ``q`` rides through un-normed — the
    reference quirk the JAX package keeps (attention.py:658-661)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.fn = fn

    def forward(self, x: torch.Tensor, q: torch.Tensor = None, **kw) -> torch.Tensor:
        if q is None:
            return self.fn(self.norm(x), **kw)
        return self.fn(self.norm(x), q, **kw)


class Local3dAttentionTransformer(nn.Module):
    """Token embedding + factorized 3D position embedding + pre-norm stack of
    local-attention / MLP residual blocks (local_3d_attention.py:121-163).
    ``backend`` is every ``Local3dAttention``'s.

    Input (B, S, H, W) int tokens; output (B, S, H, W, dim) features.
    """

    def __init__(
        self,
        data_shape: Tuple[int, int, int],
        dim: int,
        num_classes: int,
        extents: Tuple[int, int, int],
        depth: int,
        heads: int,
        dim_head: int,
        mlp_dim: int,
        dropout: float = 0.0,
        backend: str = "auto",
        use_checkpointing: bool = True,
    ):
        super().__init__()
        self.embedding = Embedding(num_classes, dim)
        self.pos_emb_s = Embedding(data_shape[0], dim)
        self.pos_emb_h = Embedding(data_shape[1], dim)
        self.pos_emb_w = Embedding(data_shape[2], dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(dim, Local3dAttention(
                    dim, extents, heads=heads, dim_head=dim_head,
                    dropout=dropout, backend=backend,
                    use_checkpointing=use_checkpointing,
                )),
                PreNorm(dim, FeedForward(dim, mlp_dim, dropout=dropout)),
            ])
            for _ in range(depth)
        )
        # the seq axis (parallel.sequence.attach_seq): the tokens are this
        # rank's frames of the clip
        self.seq = None

    def get_pos_embedding(self, s: int, h: int, w: int, s0: int = 0) -> torch.Tensor:
        """Sum of learned s/h/w embeddings of frames s0 .. s0 + s - 1,
        (S, H, W, dim)."""
        dev = self.pos_emb_s.weight.device
        s_emb = self.pos_emb_s(torch.arange(s0, s0 + s, device=dev))
        h_emb = self.pos_emb_h(torch.arange(h, device=dev))
        w_emb = self.pos_emb_w(torch.arange(w, device=dev))
        return (
            s_emb[:, None, None, :]
            + h_emb[None, :, None, :]
            + w_emb[None, None, :, :]
        )

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        _, s, h, w = tokens.shape
        x = self.embedding(tokens.long())
        s0 = 0 if self.seq is None else self.seq.index * s
        x = x + self.get_pos_embedding(s, h, w, s0)[None]
        for attn, ff in self.layers:
            x = attn(x, q=x, residual=x)
            x = ff(x, residual=x)
        return x


# ---------------------------------------------------------------------------
# Dense attention
# ---------------------------------------------------------------------------


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    dropout: float = 0.0,
) -> torch.Tensor:
    """The JAX package's ``backend="xla"`` branch (attention.py:217-226):
    f32 scores, softmax, weights cast to v's dtype (after dropout with
    probability ``dropout``), product with v.

    Args:
      q, k, v: (B, H, N, D).

    Returns:
      (B, H, N, D) in v's dtype.
    """
    scores = torch.einsum("bhnd,bhmd->bhnm", _f32(q), _f32(k)) * scale
    attn = torch.softmax(scores, dim=-1)
    if dropout > 0.0:
        attn = F.dropout(attn, dropout)
    return torch.einsum("bhnm,bhmd->bhnd", attn.to(v.dtype), v)


def _probs(q, k, lse, scale):
    """exp(scale * q k^T - lse): the attention weights rebuilt from the
    forward's log-sum-exp, f32 (or wider)."""
    scores = torch.einsum("bhnd,bhmd->bhnm", _f32(q), _f32(k)) * scale
    return torch.exp(scores - lse[..., None])


def dense_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: softmax(scale * q k^T) v as the
    stock TPU forward computes it (flash_attention.py:_flash_attention_kernel
    :331), with the key blocks of ``flash_block_size``. Per block, in
    order, with f32 (or wider) scores s and sums:

      m' = max(m, max s),  P = exp(s - m'),  l_corr = exp(m - m') l,
      l' = sum P + l_corr,
      acc = acc * (l_corr / l') + (round(P) v) / l'   (:440-473);

    a single block (N padded to 128, 256 or 512) normalises first:
    out = round(P / l) v (:540-553). round() is the operand dtype (bf16
    rounds, f32 and wider keep their values).

    Args:
      q, k, v: (B, H, N, D).

    Returns:
      out (B, H, N, D) in q's dtype, and lse = m + log l (B, H, N), f32
      (float64 for float64 inputs): the log-sum-exp of each query's scaled
      scores, the backward's input.
    """
    n = q.shape[2]
    block, padded = dense_kernels.flash_block_size(n)
    scores = torch.einsum("bhnd,bhmd->bhnm", _f32(q), _f32(k)) * scale
    vf = _f32(v)
    if block == padded:
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(-1, keepdim=True)
        acc = torch.einsum("bhnm,bhmd->bhnd", _rounded(p / l, v.dtype), vf)
    else:
        m = l = acc = None
        for k0 in range(0, n, block):
            s = scores[..., k0:k0 + block]
            m_next = s.amax(-1, keepdim=True)
            if m is not None:
                m_next = torch.maximum(m, m_next)
            p = torch.exp(s - m_next)
            l_corr = 0.0 if m is None else torch.exp(m - m_next) * l
            l_next = p.sum(-1, keepdim=True) + l_corr
            inv = 1.0 / l_next
            o = torch.einsum("bhnm,bhmd->bhnd", _rounded(p, v.dtype),
                             vf[..., k0:k0 + block, :]) * inv
            acc = o if acc is None else acc * (l_corr * inv) + o
            m, l = m_next, l_next
    lse = (m + torch.log(l))[..., 0]
    return acc.to(q.dtype), lse


def dense_attention_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    g: torch.Tensor,
    lse: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass 1 (plain version of the query-centric kernel):

      delta = rowsum(g * o),  P = exp(scale * q k^T - lse),
      dS = scale * P * (g v^T - delta),  dq = dS k.

    Args:
      q, k, v, o (the forward's output), g (its cotangent): (B, H, N, D);
      lse: the forward's (B, H, N) f32 log-sum-exp.

    Returns:
      dq in q's dtype, and delta (B, H, N) f32. Sums in f32 or wider; for
      bf16 operands dS is rounded to bf16 before dS k, as the stock TPU
      kernel casts it (flash_attention.py:1258).
    """
    delta = (_f32(g) * _f32(o)).sum(-1)
    p = _probs(q, k, lse, scale)
    dp = torch.einsum("bhnd,bhmd->bhnm", _f32(g), _f32(v))
    ds = p * (dp - delta[..., None])
    if narrow(k.dtype):
        dq = torch.einsum("bhnm,bhmd->bhnd", _rounded(ds * scale, k.dtype), _f32(k))
    else:
        dq = torch.einsum("bhnm,bhmd->bhnd", ds, _f32(k)) * scale
    return dq.to(q.dtype), delta


def dense_attention_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass 2 (plain version of the key-centric kernel), with P
    rebuilt from lse:

      dv = P^T g,  dk = dS^T q,  dS = scale * P * (g v^T - delta).

    Returns:
      (dk, dv) in k's and v's dtypes. Sums in f32 or wider; for bf16
      operands P and dS are rounded to bf16 before their products, as the
      stock TPU kernel casts them (flash_attention.py:900, :918).
    """
    p = _probs(q, k, lse, scale)
    dp = torch.einsum("bhnd,bhmd->bhnm", _f32(g), _f32(v))
    ds = p * (dp - delta[..., None])
    if narrow(g.dtype):
        dv = torch.einsum("bhnm,bhnd->bhmd", _rounded(p, g.dtype), _f32(g))
        dk = torch.einsum("bhnm,bhnd->bhmd", _rounded(ds * scale, g.dtype), _f32(q))
    else:
        dv = torch.einsum("bhnm,bhnd->bhmd", p, _f32(g))
        dk = torch.einsum("bhnm,bhnd->bhmd", ds, _f32(q)) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


class DenseAttention(nn.Module):
    """Fused-QKV multi-head self-attention (transformer.py:34-64).

    ``to_qkv`` is one bias-free Linear to 3 * heads * dim_head, split q | k
    | v and then heads-major; ``to_out`` (with a bias) runs unless ``heads
    == 1 and dim_head == dim``. ``backend`` follows the JAX package with
    the GPU in the TPU's place:
    - ``"auto"``: the flash kernels on a CUDA tensor when N >= 1024 and
      dropout is 0, else the plain ``dense_attention`` (JAX's own ``xla``
      routing);
    - ``"flash"``: the autograd Function ``kernels.dense_attention.
      flash_attention`` (the kernels on CUDA, their plain versions on the
      CPU); raises with dropout > 0;
    - ``"xla"``: the plain ``dense_attention``.
    The dropout on the attention weights and after ``to_out`` follows
    ``module.train()``. Under tensor parallelism (``tp``, ``parallel.mesh.
    shard_params``) a rank holds its rows of each of q, k and v in
    ``to_qkv`` (the fused projection's rows are [q | k | v], so each block
    is cut by heads) and its columns of ``to_out``: the attention runs on
    its heads, or on q, k and v gathered whole where ``heads`` does not
    divide, and ``to_out`` is row-parallel. ``forward(x, residual)``
    returns the output plus ``residual``; without ``tp``, where
    ``ops.dense.tf32_route`` takes them, ``to_qkv`` and ``to_out`` (with its
    bias and the residual in the epilogue) run on the split-TF32 kernel.
    """

    tp_params = ("to_qkv.weight", "to_out.0.weight")
    tp_chunks = {"to_qkv.weight": 3}

    def __init__(
        self,
        dim: int,
        heads: int = 8,
        dim_head: int = 64,
        dropout: float = 0.0,
        backend: str = "auto",
    ):
        super().__init__()
        if backend not in ("auto", "flash", "xla"):
            raise ValueError(
                f"backend must be 'auto', 'flash' or 'xla', got {backend!r}")
        if backend == "flash" and dropout > 0.0:
            raise ValueError(
                "backend='flash' cannot apply attention-weight dropout")
        self.heads, self.dim_head = heads, dim_head
        self.dropout, self.backend = dropout, backend
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = None
        if not (heads == 1 and dim_head == dim):
            self.to_out = nn.Sequential(Dense(inner, dim), nn.Dropout(dropout))
        self.tp = None

    def tp_supported(self, n: int) -> bool:
        return self.to_out is not None and (self.heads * self.dim_head) % n == 0

    def uses_flash(self, x: torch.Tensor) -> bool:
        """Whether a forward on ``x`` (B, N, dim) goes through the flash
        Function."""
        if self.backend == "flash":
            return True
        return (self.backend == "auto" and x.is_cuda and self.dropout == 0.0
                and x.shape[1] >= FLASH_MIN_TOKENS)

    def forward(self, x: torch.Tensor, residual: torch.Tensor = None) -> torch.Tensor:
        """x: normed (B, N, dim) -> (B, N, dim), plus ``residual``."""
        b, n, _ = x.shape
        tp, heads = self.tp, self.heads
        if tp is not None:
            x = copy_to(x, tp)
        qkv = dense_layer(x, self.to_qkv.weight, attached=tp is not None).chunk(3, dim=-1)
        if tp is not None:
            if heads % tp.size == 0:
                heads //= tp.size
            else:
                qkv = [gather_from(t, tp) for t in qkv]
        # (B, H, N, D) views of the fused projection: no copies
        q, k, v = (t.reshape(b, n, heads, self.dim_head).transpose(1, 2) for t in qkv)
        scale = self.dim_head**-0.5
        if self.uses_flash(x):
            out = dense_kernels.flash_attention(q, k, v, scale)
        else:
            out = dense_attention(
                q, k, v, scale, self.dropout if self.training else 0.0)
        out = out.transpose(1, 2).reshape(b, n, heads * self.dim_head)
        if tp is not None:
            proj = self.to_out[0]
            width = proj.weight.shape[1]
            if heads == self.heads:  # this rank's columns of the whole output
                out = out[..., tp.index * width:(tp.index + 1) * width]
            return _plus(self.to_out[1](_row_parallel(out, proj.weight, proj.bias, tp)),
                         residual)
        if self.to_out is None:
            return _plus(out, residual)
        proj, drop = self.to_out
        return dense_layer(out, proj.weight, proj.bias, dropout=drop, residual=residual)


class DenseTransformer(nn.Module):
    """Pre-norm residual stack of DenseAttention / FeedForward blocks
    (transformer.py:67-80), LayerNorm eps 1e-6. Submodules are named as
    the reference state_dict (``layers.{i}.0.fn.to_qkv`` ...). With
    ``moe_experts`` > 0 every FFN is a ``MoEFeedForward``
    (``layers.{i}.1.fn.w_gate`` ...) of ``moe_experts`` experts of width
    ``mlp_dim``; ``forward(x, return_aux=True)`` then also returns the
    layers' mean load-balance loss (the JAX trainer's mean over the sown
    ``moe_aux`` values). Without ``return_aux`` the term is dropped, and its
    means cross no data axis."""

    def __init__(
        self,
        dim: int,
        depth: int,
        heads: int,
        dim_head: int,
        mlp_dim: int,
        dropout: float = 0.0,
        attn_backend: str = "auto",
        moe_experts: int = 0,
        moe_capacity_factor: float = 1.25,
        moe_impl: str = "dispatch",
    ):
        super().__init__()

        def ffn():
            if moe_experts > 0:
                return MoEFeedForward(dim, mlp_dim, moe_experts,
                                      capacity_factor=moe_capacity_factor, impl=moe_impl)
            return FeedForward(dim, mlp_dim, dropout=dropout)

        self.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(dim, DenseAttention(
                    dim, heads=heads, dim_head=dim_head, dropout=dropout,
                    backend=attn_backend,
                )),
                PreNorm(dim, ffn()),
            ])
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, return_aux: bool = False):
        aux = []
        for attn, ff in self.layers:
            x = attn(x, residual=x)
            if isinstance(ff.fn, MoEFeedForward):
                y, a = ff(x, global_aux=return_aux)
                aux.append(a)
                x = y + x
            else:
                x = ff(x, residual=x)
        if not return_aux:
            return x
        if not aux:
            raise ValueError("return_aux needs mixture-of-experts FFNs (moe_experts > 0)")
        total = aux[0]  # summed in layer order, as JAX's Python sum
        for a in aux[1:]:
            total = total + a
        return x, total / len(aux)
