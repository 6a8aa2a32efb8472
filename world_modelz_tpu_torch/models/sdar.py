"""SDAR's block-diffusion MoE decoder (JetLM/SDAR-30B-A3B-Chat, model type
``sdar_moe``; the Qwen3-MoE block it was converted from), at one card's
share of an expert-parallel layer.

A layer, pre-norm with RMSNorm (eps 1e-6; Qwen3's: x normalised in f32,
cast back, times the weight):

- attention: bias-free q, k, v projections (q ``heads`` x ``head_dim`` wide,
  k and v ``kv_heads`` x ``head_dim``), RMSNorm over each head's
  ``head_dim`` (``q_norm``, ``k_norm``), rotary embeddings (theta
  ``rope_theta``, the halves rotated), grouped-query attention under the
  block-diffusion mask of [x_t ; x_0] (``kernels.dense_attention.
  bd_attention``: the ``bdflash_*`` kernels on the card), ``o_proj``, the
  residual;
- experts: the f32 softmax of the router's f32 product over all
  ``num_experts``, its top ``top_k`` renormalised; each token through each
  of its selected experts that this card holds (``held``), SwiGLU
  down(silu(gate(x)) up(x)) with no biases, weighted and summed
  (``parallel.moe.moe_swiglu_held``: the grouped ``expert_gemm_*`` kernels
  on the card); the residual.

Then the final RMSNorm and the untied head over the vocabulary slice, on
the noisy half only (the loss reads nothing else). The model sees 2 L
positions, [x_t ; x_0], both halves at positions 0 .. L - 1. The expert
layer takes the tokens ``MOE_CHUNK_TOKENS`` at a time (its grouped
buffers hold the worst routing of a chunk, 8 rows a token).

Parameters are named as the Hugging Face checkpoint names them, but for
the experts, which are stacked: ``mlp.experts.gate_up`` (E_held, 2 I, D:
gate rows then up rows) and ``mlp.experts.down`` (E_held, D, I).
``RMSNorm`` and ``rope`` are autograd Functions that keep their inputs
(and the f32 row scales) and recompute the rest in the backward, so a
layer keeps no f32 copy of its activations.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from world_modelz_tpu_torch.kernels.dense_attention import bd_attention
from world_modelz_tpu_torch.parallel.moe import moe_swiglu_held

# tokens an expert-layer call routes: at 16,384 a call's grouped buffers
# (the worst routing) take ~3 GB in bf16 beside the step's ~30 GB of
# activations on an 80 GB card
MOE_CHUNK_TOKENS = 16384


class _RMSNorm(torch.autograd.Function):
    """w * cast(x rsqrt(mean(x^2) + eps)) over the last axis, x normalised in
    f32 (Qwen3's RMSNorm); the backward is autograd's through the same
    operations, the product's rounding included."""

    @staticmethod
    def forward(ctx, x, w, eps):
        xf = x.float()
        rstd = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, w, rstd)
        return w * (xf * rstd).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        xhat = x.float() * rstd
        dw = (dy * xhat.to(x.dtype)).reshape(-1, w.shape[0]).float().sum(0).to(w.dtype)
        g = (dy * w).float()
        dx = rstd * (g - xhat * (g * xhat).mean(-1, keepdim=True))
        return dx.to(x.dtype), dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return _RMSNorm.apply(x, w, eps)


def rope_tables(positions: torch.Tensor, dim: int, theta: float, dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (N, dim) of the rotary embedding at ``positions``, made in
    f32 and cast to ``dtype`` (Qwen3's)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim)
    freqs = positions.float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _rotate_half_t(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([x[..., h:], -x[..., :h]], dim=-1)


class _Rope(torch.autograd.Function):
    """x cos + rotate_half(x) sin for (B, N, H, D) x and (N, D) tables."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        c, s = cos[:, None], sin[:, None]
        return x * c + _rotate_half(x) * s

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        return dy * cos[:, None] + _rotate_half_t(dy * sin[:, None]), None, None


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    return _Rope.apply(x, cos, sin)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class SdarAttention(nn.Module):
    def __init__(self, dim: int, heads: int, kv_heads: int, head_dim: int, eps: float,
                 device=None):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, head_dim
        self.q_proj = nn.Linear(dim, heads * head_dim, bias=False, device=device)
        self.k_proj = nn.Linear(dim, kv_heads * head_dim, bias=False, device=device)
        self.v_proj = nn.Linear(dim, kv_heads * head_dim, bias=False, device=device)
        self.o_proj = nn.Linear(heads * head_dim, dim, bias=False, device=device)
        self.q_norm = RMSNorm(head_dim, eps, device)
        self.k_norm = RMSNorm(head_dim, eps, device)

    def forward(self, x, cos, sin, block: int):
        b, n, _ = x.shape
        hd = self.head_dim
        q = rope(self.q_norm(self.q_proj(x).view(b, n, self.heads, hd)), cos, sin)
        k = rope(self.k_norm(self.k_proj(x).view(b, n, self.kv_heads, hd)), cos, sin)
        v = self.v_proj(x).view(b, n, self.kv_heads, hd)
        o = bd_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), block,
                         hd ** -0.5)
        return self.o_proj(o.transpose(1, 2).reshape(b, n, self.heads * hd))


class StackedExperts(nn.Module):
    """The stacked SwiGLU experts this card holds."""

    def __init__(self, dim: int, expert_dim: int, held: int, device=None):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(held, 2 * expert_dim, dim, device=device))
        self.down = nn.Parameter(torch.empty(held, dim, expert_dim, device=device))
        nn.init.normal_(self.gate_up, std=dim ** -0.5)
        nn.init.normal_(self.down, std=expert_dim ** -0.5)


class SdarMoE(nn.Module):
    def __init__(self, dim: int, expert_dim: int, num_experts: int, top_k: int,
                 held: torch.Tensor, normalise: bool, device=None):
        super().__init__()
        self.gate = nn.Linear(dim, num_experts, bias=False, device=device)
        self.experts = StackedExperts(dim, expert_dim, held.shape[0], device)
        self.register_buffer("held", held.to(device), persistent=False)
        self.top_k, self.normalise = top_k, normalise

    def forward(self, x, chunk: int):
        """(out, held assignments a held expert, placed assignments), the
        tokens ``chunk`` at a time: the grouped buffers are sized for the
        worst routing of a chunk."""
        b, n, d = x.shape
        outs, counts, placed = [], 0, 0
        for xc in x.reshape(-1, d).split(chunk):
            out, plan = moe_swiglu_held(xc, self.gate.weight, self.experts.gate_up,
                                        self.experts.down, self.held, self.top_k,
                                        self.normalise)
            outs.append(out)
            counts, placed = counts + plan.counts, placed + plan.placed
        return torch.cat(outs).reshape(b, n, d), counts, placed


class SdarLayer(nn.Module):
    def __init__(self, cfg, held: torch.Tensor, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim, cfg.rms_eps, device)
        self.self_attn = SdarAttention(cfg.dim, cfg.heads, cfg.kv_heads, cfg.head_dim,
                                       cfg.rms_eps, device)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.rms_eps, device)
        self.mlp = SdarMoE(cfg.dim, cfg.expert_dim, cfg.num_experts, cfg.top_k, held,
                           cfg.norm_topk_prob, device)

    def forward(self, x, cos, sin, block: int, chunk: int):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, block)
        y, counts, placed = self.mlp(self.post_attention_layernorm(x), chunk)
        return x + y, counts, placed


class SdarBody(nn.Module):
    def __init__(self, cfg, held: torch.Tensor, device=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab, cfg.dim, device=device)
        self.layers = nn.ModuleList(SdarLayer(cfg, held, device) for _ in range(cfg.depth))
        self.norm = RMSNorm(cfg.dim, cfg.rms_eps, device)


class SdarModel(nn.Module):
    """``forward(tokens (B, 2 L), block)`` -> (logits (B, L, vocab) of the
    noisy half, stats (3,) f32: the layers' held assignments, the largest
    held expert's assignments over their mean (the most loaded layer's),
    assignments not placed, which must be 0)."""

    def __init__(self, cfg, held: torch.Tensor, device=None):
        super().__init__()
        self.cfg = cfg
        self.model = SdarBody(cfg, held, device)
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab, bias=False, device=device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, tokens: torch.Tensor, block: int):
        cfg = self.cfg
        n = tokens.shape[1]
        half = n // 2
        x = self.model.embed_tokens(tokens)
        positions = torch.arange(n, device=tokens.device) % half
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.dtype)
        held, load, unplaced = [], [], []
        for layer in self.model.layers:
            x, counts, placed = layer(x, cos, sin, block, MOE_CHUNK_TOKENS)
            counts = counts.float()
            held.append(counts.sum())
            load.append(counts.max() / counts.mean().clamp_min(1e-30))
            unplaced.append(counts.sum() - placed.float())
        x = self.model.norm(x[:, :half])
        stats = torch.stack([torch.stack(held).sum(), torch.stack(load).max(),
                             torch.stack(unplaced).sum()])
        return self.lm_head(x), stats
