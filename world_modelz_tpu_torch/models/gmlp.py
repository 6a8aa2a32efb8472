"""gMLP with spatial gating units and optional tiny attention (port of
``world_modelz_tpu.models.gmlp``; masked_denoise_prototype/gmlp.py:30-175).

Each block projects up (dim -> dim_ff), splits the channels into (residual,
gate), mixes the gate along the token axis with a learned (seq, seq) map
initialised near zero with a unit bias, optionally adds a single-head
attention path into the gate, and projects back down. The stack is
pre-norm residual, with stochastic layer drop (``prob_survival``) and the
prototype's VQ-embedding input projection.

The modules and their parameters are named as flax names them (``block_{i}``
holds ``TinyAttention_0``, ``Dense_0``, ``SpatialGatingUnit_0`` (with
``LayerNorm_0``, ``proj_weight``, ``proj_bias``) and ``Dense_1``), so
``convert.gmlp_state_dict_from_params`` maps a JAX params tree one to one.
What differs from torch's defaults, as flax computes it: LayerNorm eps 1e-6,
the tanh approximation of GELU, and the gate weight stored as drawn from
U(0, 2 eps) with eps = init_eps / seq_len subtracted where it is used.

``TinyAttention`` is JAX's einsum attention (no Pallas kernel), so plain
torch is its port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from world_modelz_tpu_torch._device import DeviceLike, resolve_device
from world_modelz_tpu_torch.models.attention import Embedding

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0).mul_(std)


def _dense(n_in: int, n_out: int, bias: bool = True) -> nn.Linear:
    """flax's ``nn.Dense``: lecun-normal kernel, zero bias."""
    layer = nn.Linear(n_in, n_out, bias=bias)
    _lecun_normal_(layer.weight, n_in)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class TinyAttention(nn.Module):
    """Single-head attention feeding the gate (gmlp.py:48-68): scores in
    f32, a ``triu(1)`` mask when causal."""

    def __init__(self, dim: int, dim_inner: int, dim_out: int, causal: bool = False):
        super().__init__()
        self.dim_inner, self.causal = dim_inner, causal
        self.to_qkv = _dense(dim, dim_inner * 3, bias=False)
        self.to_out = _dense(dim_inner, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        sim = torch.einsum("bid,bjd->bij", q.float(), k.float()) * (self.dim_inner ** -0.5)
        if self.causal:
            n = x.shape[1]
            mask = torch.ones((n, n), dtype=torch.bool, device=x.device).triu(1)
            sim = sim.masked_fill(mask, float("-inf"))
        attn = sim.softmax(-1)
        out = torch.einsum("bij,bjd->bid", attn.to(v.dtype), v)
        return self.to_out(out)


class SpatialGatingUnit(nn.Module):
    """Split channels; the gate half normalised and mixed across tokens
    (gmlp.py:70-102)."""

    def __init__(self, dim_ff: int, seq_len: int, causal: bool = False,
                 init_eps: float = 1e-3):
        super().__init__()
        self.seq_len, self.causal = seq_len, causal
        self.eps = init_eps / seq_len
        self.LayerNorm_0 = nn.LayerNorm(dim_ff // 2, eps=LN_EPS)
        # stored as JAX stores it, U(0, 2 eps); eps is subtracted at use, so
        # the used weight is U(-eps, eps) (gmlp.py:82)
        self.proj_weight = nn.Parameter(torch.empty(seq_len, seq_len).uniform_(0.0, 2 * self.eps))
        self.proj_bias = nn.Parameter(torch.ones(seq_len))

    def forward(self, x: torch.Tensor, gate_res: Optional[torch.Tensor] = None) -> torch.Tensor:
        res, gate = x.chunk(2, dim=-1)
        gate = self.LayerNorm_0(gate)
        weight = self.proj_weight - self.eps
        if self.causal:
            keep = torch.ones_like(weight, dtype=torch.bool).tril()
            weight = torch.where(keep, weight, torch.zeros((), dtype=weight.dtype,
                                                           device=weight.device))
        # the token-axis mix (B, N, C/2) x (N, N), summed in f32, cast to
        # x's dtype, then the bias
        mixed = torch.einsum("bnc,mn->bmc", gate.float(), weight.float()).to(x.dtype)
        gate = mixed + self.proj_bias[None, :, None]
        if gate_res is not None:
            gate = gate + gate_res
        return gate * res


class GMLPBlock(nn.Module):
    def __init__(self, dim: int, dim_ff: int, seq_len: int,
                 attn_dim: Optional[int] = None, causal: bool = False):
        super().__init__()
        # flax creates the attention first, so it is TinyAttention_0 and the
        # projections Dense_0 and Dense_1
        self.TinyAttention_0 = (TinyAttention(dim, attn_dim, dim_ff // 2, causal)
                                if attn_dim else None)
        self.Dense_0 = _dense(dim, dim_ff)
        self.SpatialGatingUnit_0 = SpatialGatingUnit(dim_ff, seq_len, causal)
        self.Dense_1 = _dense(dim_ff // 2, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate_res = self.TinyAttention_0(x) if self.TinyAttention_0 is not None else None
        h = F.gelu(self.Dense_0(x), approximate="tanh")  # flax nn.gelu
        h = self.SpatialGatingUnit_0(h, gate_res)
        return self.Dense_1(h)


class GMLP(nn.Module):
    """Token-in / logits-out gMLP (gmlp.py:136-175).

    Args:
      num_tokens_in, num_tokens_out: input vocabulary (the mask token
        included) and output classes.
      dim, depth, seq_len: width, blocks, tokens a sequence.
      vq_embedding_dim: width of the VQ embeddings added through
        ``vq_embed_proj`` (None: no such input).
      ff_mult: dim_ff = dim * ff_mult.
      attn_dim: the tiny attention's width (None: no attention).
      prob_survival: layer-drop keep probability in training (1.0: off).
      causal: causal gate mix and attention.
      device: ``None`` means ``"cuda"`` (raises without a GPU); pass
        ``"cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        num_tokens_in: int,
        num_tokens_out: int,
        dim: int,
        depth: int,
        seq_len: int,
        vq_embedding_dim: Optional[int] = None,
        ff_mult: int = 4,
        attn_dim: Optional[int] = None,
        prob_survival: float = 1.0,
        causal: bool = False,
        *,
        device: DeviceLike = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.depth, self.seq_len = depth, seq_len
        self.num_tokens_out = num_tokens_out
        self.prob_survival = prob_survival
        # the port's embedding: its weight gradient has no atomics, so a
        # replayed step is bitwise the eager one
        self.to_embed = Embedding(num_tokens_in, dim)
        # flax nn.Embed's init: variance_scaling(1, fan_in, normal) over dim
        nn.init.normal_(self.to_embed.weight, 0.0, 1.0 / math.sqrt(dim))
        self.vq_embed_proj = (_dense(vq_embedding_dim, dim)
                              if vq_embedding_dim is not None else None)
        for i in range(depth):
            setattr(self, f"block_{i}", GMLPBlock(dim, dim * ff_mult, seq_len,
                                                  attn_dim, causal))
            setattr(self, f"norm_{i}", nn.LayerNorm(dim, eps=LN_EPS))
        self.final_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.to_logits = _dense(dim, num_tokens_out)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.to_embed.weight.device

    def forward(
        self,
        tokens: torch.Tensor,
        vq_embeddings: Optional[torch.Tensor] = None,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(B, N) int tokens (and (B, N, vq_embedding_dim) embeddings) ->
        (B, N, num_tokens_out) logits. With ``train`` and ``prob_survival``
        < 1, each block's output is kept with that probability, one
        Bernoulli draw a block from ``generator``."""
        x = self.to_embed(tokens.long())
        if self.vq_embed_proj is not None:
            x = x + self.vq_embed_proj(vq_embeddings)
        drop = train and self.prob_survival < 1.0
        for i in range(self.depth):
            y = getattr(self, f"block_{i}")(getattr(self, f"norm_{i}")(x))
            if drop:
                u = torch.rand((), generator=generator, device=x.device)
                y = y * (u < self.prob_survival).to(x.dtype)
            x = x + y
        return self.to_logits(self.final_norm(x))
