"""NÜWA-style local 3D attention transformer.

Port of ``world_modelz_tpu.models.attention`` (reference:
vq-video-diffusion/local_3d_attention.py:34-163): every (s, h, w) token of a
(B, S, H, W) token grid attends to its (2e_s+1)(2e_h+1)(2e_w+1) space-time
neighbourhood, with border masking and factorized learned s/h/w position
embeddings.

``local3d_attention`` is the plain version of the CUDA forward kernel
(``kernels/local3d.py``), written as the JAX package writes it: keys and
values stacked for the 2e_s+1 frame offsets, dense per-frame scores, and an
additive -1e9 mask for pairs outside the spatial window or off the clip.
CPU tensors and the tests use it; ``Local3dAttention`` on CUDA launches the
kernel. Submodule names follow the reference state_dict layout
(``transformer.layers.{i}.0.fn.to_q`` ...), so the weight bridge
(``convert.py``) loads with ``strict=True``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from world_modelz_tpu_torch.kernels.local3d import local3d_attention_fwd

NEG_INF = -1e9  # reference mask value (local_3d_attention.py:92)


class FeedForward(nn.Module):
    """Linear -> GELU (tanh approximation, flax's ``nn.gelu``) -> Linear
    (transformer.py:20-31)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim),
            nn.GELU(approximate="tanh"),
            nn.Dropout(dropout),
            nn.Linear(hidden_dim, dim),
            nn.Dropout(dropout),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


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
    zero off the ends of the clip (those keys are masked)."""
    seq = t.shape[1]
    stacks = []
    for ds in range(-es, es + 1):
        shifted = torch.zeros_like(t)
        if ds < 0:
            shifted[:, -ds:] = t[:, : seq + ds]
        elif ds > 0:
            shifted[:, : seq - ds] = t[:, ds:]
        else:
            shifted = t
        stacks.append(shifted)
    return torch.stack(stacks, dim=2)


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

    def to_heads(t):
        return (
            t.reshape(b, s, hw, heads, dh)
            .permute(0, 3, 1, 2, 4)
            .reshape(b * heads, s, hw, dh)
        )

    qh = to_heads(q)
    kh = _shift_stack_frames(to_heads(k), es)  # (Z, S, Ts, HW, dh)
    vh = _shift_stack_frames(to_heads(v), es)

    scale = dh**-0.5
    scores = torch.einsum("zsqd,zstkd->zsqtk", qh.float(), kh.float()) * scale
    scores = scores + local3d_attention_weights_mask(s, h, w, extents, q.device)
    attn = torch.softmax(
        scores.reshape(b * heads, s, hw, ts * hw), dim=-1
    ).reshape(scores.shape)
    out = torch.einsum("zsqtk,zstkd->zsqd", attn.to(vh.dtype), vh)
    return (
        out.reshape(b, heads, s, hw, dh)
        .permute(0, 2, 3, 1, 4)
        .reshape(b, s, h, w, inner)
    )


class Local3dAttention(nn.Module):
    """QKV projections around the windowed attention core
    (local_3d_attention.py:34-118). ``to_q`` and ``to_k`` have no bias,
    ``to_v`` and ``to_out`` do; ``to_out`` is absent when
    ``heads == 1 and dim_head == dim``."""

    def __init__(
        self,
        dim: int,
        extents: Tuple[int, int, int],
        heads: int = 8,
        dim_head: int = 64,
        dropout: float = 0.0,
    ):
        super().__init__()
        inner = heads * dim_head
        self.extents = tuple(int(e) for e in extents)
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=True)
        self.to_out = None
        if not (heads == 1 and dim_head == dim):
            self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """x: normed (B, S, H, W, dim) key/value input; q: query input."""
        out = local3d_attention_fwd(
            self.to_q(q), self.to_k(x), self.to_v(x), self.extents, self.heads
        )
        if self.to_out is not None:
            out = self.to_out(out)
        return out


class PreNorm(nn.Module):
    """LayerNorm (eps 1e-6, the flax default) before ``fn``. With ``q``
    given, only ``x`` is normed and ``q`` rides through un-normed — the
    reference quirk the JAX package keeps (attention.py:658-661)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.fn = fn

    def forward(self, x: torch.Tensor, q: torch.Tensor = None) -> torch.Tensor:
        if q is None:
            return self.fn(self.norm(x))
        return self.fn(self.norm(x), q)


class Local3dAttentionTransformer(nn.Module):
    """Token embedding + factorized 3D position embedding + pre-norm stack of
    local-attention / MLP residual blocks (local_3d_attention.py:121-163).

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
    ):
        super().__init__()
        self.embedding = nn.Embedding(num_classes, dim)
        self.pos_emb_s = nn.Embedding(data_shape[0], dim)
        self.pos_emb_h = nn.Embedding(data_shape[1], dim)
        self.pos_emb_w = nn.Embedding(data_shape[2], dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(dim, Local3dAttention(
                    dim, extents, heads=heads, dim_head=dim_head,
                    dropout=dropout,
                )),
                PreNorm(dim, FeedForward(dim, mlp_dim, dropout=dropout)),
            ])
            for _ in range(depth)
        )

    def get_pos_embedding(self, s: int, h: int, w: int) -> torch.Tensor:
        """Sum of learned s/h/w embeddings, (S, H, W, dim)."""
        dev = self.pos_emb_s.weight.device
        s_emb = self.pos_emb_s(torch.arange(s, device=dev))
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
        x = x + self.get_pos_embedding(s, h, w)[None]
        for attn, ff in self.layers:
            x = attn(x, q=x) + x
            x = ff(x) + x
        return x
