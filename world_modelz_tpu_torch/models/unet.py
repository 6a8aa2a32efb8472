"""UNet denoiser for the continuous DDPM.

Port of ``world_modelz_tpu.models.unet`` (reference: ``UNetDiffusionModel``,
som-diffusion/diffusion_model_unet.py:210-339, an improved-diffusion
derivative): the sinusoidal timestep embedding with the reference's
``stretch`` (:320-324), ResBlocks with scale-shift GroupNorm conditioning
(:103-157), spatial self-attention with the split-scale softmax (:160-207),
the symmetric down/middle/up path with skip concatenation, and
zero-initialized output convolutions (:26-32); and
``SimpleDiffusionModel`` (som-diffusion/diffusion_model.py:10-99), its
conv-resnet predecessor.

Tensors are NHWC at ``forward`` (x (B, H, W, C), continuous t (B, 1)) and
NCHW inside. GroupNorm keeps flax's eps 1e-6 (torch's default is 1e-5).
Each block keeps its layers in lists in flax's creation order (``convs``,
``norms``, ``dense``, ``res``, ``attn``: flax's ``Conv_{k}``,
``GroupNorm_{k}``, ``Dense_{k}``, ``ResBlock_{k}``, ``AttentionBlock_{k}``),
and a forward takes them in that order, so ``convert.unet_state_dict_from_
params`` renames flax's tree without knowing the architecture. Flax's 1-D
``Conv(3c, (1,))`` qkv and proj_out of the attention are linear layers over
the channels; ``jax.image.resize(..., "nearest")`` at exactly 2x is a
repeat of each pixel.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from world_modelz_tpu_torch._device import DeviceLike, resolve_device

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon


def timestep_embedding(t: torch.Tensor, dim: int, stretch: float = 5000.0,
                       max_period: float = 1e4) -> torch.Tensor:
    """(B, 1) continuous t -> (B, dim) [sin | cos] features, f32
    (diffusion_model_unet.py:320-324)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half) * stretch
    args = t.reshape(-1, 1).float() * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=GN_EPS)


def _zeros(m: nn.Module) -> nn.Module:
    """zero_module (:26-32): weights and bias at zero."""
    for p in m.parameters():
        nn.init.zeros_(p)
    return m


class ResBlock(nn.Module):
    """GroupNorm -> SiLU -> conv3x3, then the timestep's scale and shift
    around a second GroupNorm, SiLU, dropout and a zero-initialized conv3x3;
    a 1x1 conv on the skip when the width changes (:103-157)."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, dropout: float = 0.0,
                 use_scale_shift_norm: bool = True):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.norms = nn.ModuleList([_gn(in_ch), _gn(out_ch)])
        convs = [nn.Conv2d(in_ch, out_ch, 3, padding=1),
                 _zeros(nn.Conv2d(out_ch, out_ch, 3, padding=1))]
        if in_ch != out_ch:
            convs.append(nn.Conv2d(in_ch, out_ch, 1))
        self.convs = nn.ModuleList(convs)
        self.dense = nn.ModuleList([
            nn.Linear(emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch)])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.convs[0](F.silu(self.norms[0](x)))
        emb_out = self.dense[0](F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.norms[1](h) * (1 + scale) + shift
        else:
            h = self.norms[1](h + emb_out)
        h = self.convs[1](self.dropout(F.silu(h)))
        if len(self.convs) > 2:
            x = self.convs[2](x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention with the split-scale softmax (:160-207): q
    and k each scaled by ch^-1/4, the scores and softmax in f32; per head
    the qkv channels are [q | k | v]; the output projection starts at
    zero."""

    def __init__(self, channels: int, num_heads: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.norms = nn.ModuleList([_gn(channels)])
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = _zeros(nn.Linear(channels, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        heads, ch = self.num_heads, c // self.num_heads
        normed = self.norms[0](x).reshape(b, c, hh * ww).transpose(1, 2)  # (B, HW, C)
        qkv = self.qkv(normed).reshape(b, hh * ww, heads, 3 * ch)
        q, k, v = qkv.chunk(3, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        attn = torch.einsum("bnhc,bmhc->bhnm", q * scale, k * scale).float()
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhc->bnhc", attn, v).reshape(b, hh * ww, c)
        out = self.proj_out(out)
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class UNetDiffusionModel(nn.Module):
    """(x (B, H, W, C), t (B, 1)) -> the eps prediction (B, H, W, C).

    The JAX module's fields and defaults. ``device=None`` means ``"cuda"``.
    The model starts in eval mode (dropout off); a trainer calls
    ``.train()``."""

    def __init__(
        self,
        in_channels: int = 2,
        out_channels: int = 2,
        model_channels: int = 128,
        num_res_blocks: int = 3,
        channel_mult: Sequence[int] = (1, 2, 3, 4),
        dropout: float = 0.0,
        use_scale_shift_norm: bool = True,
        attention_resolutions: Sequence[int] = (2, 4),
        num_heads: int = 4,
        num_heads_upsample: int = 4,
        *,
        device: DeviceLike = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.model_channels = model_channels
        self.num_res_blocks = num_res_blocks
        self.channel_mult = tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        emb_dim = model_channels * 4
        self.dense = nn.ModuleList([nn.Linear(model_channels, emb_dim),
                                    nn.Linear(emb_dim, emb_dim)])
        convs = [nn.Conv2d(in_channels, model_channels, 3, padding=1)]
        res, attn = [], []

        def resblock(cin, cout):
            res.append(ResBlock(cin, cout, emb_dim, dropout, use_scale_shift_norm))
            return cout

        # the construction replays the forward's order (flax's counters)
        ch, chans, ds = model_channels, [model_channels], 1
        for level, mult in enumerate(self.channel_mult):
            for _ in range(num_res_blocks):
                ch = resblock(ch, mult * model_channels)
                if ds in self.attention_resolutions:
                    attn.append(AttentionBlock(ch, num_heads))
                chans.append(ch)
            if level != len(self.channel_mult) - 1:
                convs.append(nn.Conv2d(ch, ch, 3, stride=2, padding=1))
                chans.append(ch)
                ds *= 2
        ch = resblock(ch, ch)
        attn.append(AttentionBlock(ch, num_heads))
        ch = resblock(ch, ch)
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                ch = resblock(ch + chans.pop(), model_channels * mult)
                if ds in self.attention_resolutions:
                    attn.append(AttentionBlock(ch, num_heads_upsample))
                if level and i == num_res_blocks:
                    convs.append(nn.Conv2d(ch, ch, 3, padding=1))
                    ds //= 2
        self.norms = nn.ModuleList([_gn(ch)])
        convs.append(_zeros(nn.Conv2d(ch, out_channels, 3, padding=1)))
        self.convs = nn.ModuleList(convs)
        self.res = nn.ModuleList(res)
        self.attn = nn.ModuleList(attn)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.convs[0].weight.device

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        convs, res, attn = iter(self.convs), iter(self.res), iter(self.attn)
        emb = timestep_embedding(t, self.model_channels)
        emb = self.dense[1](F.silu(self.dense[0](emb)))
        h = next(convs)(x.permute(0, 3, 1, 2))
        hs, ds = [h], 1
        for level, _ in enumerate(self.channel_mult):
            for _ in range(self.num_res_blocks):
                h = next(res)(h, emb)
                if ds in self.attention_resolutions:
                    h = next(attn)(h)
                hs.append(h)
            if level != len(self.channel_mult) - 1:
                h = next(convs)(h)
                hs.append(h)
                ds *= 2
        h = next(res)(h, emb)
        h = next(attn)(h)
        h = next(res)(h, emb)
        for level, _ in reversed(list(enumerate(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = next(res)(torch.cat([h, hs.pop()], dim=1), emb)
                if ds in self.attention_resolutions:
                    h = next(attn)(h)
                if level and i == self.num_res_blocks:
                    h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                    h = next(convs)(h)
                    ds //= 2
        h = next(convs)(F.silu(self.norms[0](h)))
        return h.permute(0, 2, 3, 1)


class SimpleDiffusionModel(nn.Module):
    """Conv-resnet denoiser with a sinusoidal t (stretch 1) concatenated to
    every pixel (som-diffusion/diffusion_model.py:10-99): (x (B, H, W, C),
    t (B, 1)) -> (B, H, W, out_channels). ``in_channels`` is the width of x
    (flax infers it)."""

    def __init__(
        self,
        d_model: int = 256,
        num_layers: int = 8,
        d_pos: int = 32,
        dropout: float = 0.0,
        out_channels: int = 2,
        in_channels: int = 2,
        *,
        device: DeviceLike = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.d_pos, self.num_layers = d_pos, num_layers
        convs = [nn.Conv2d(in_channels + d_pos, d_model, 3, padding=1)]
        norms = []
        for _ in range(num_layers):
            norms += [_gn(d_model), _gn(d_model)]
            convs += [nn.Conv2d(d_model, d_model, 3, padding=1),
                      nn.Conv2d(d_model, d_model, 3, padding=1)]
        norms.append(_gn(d_model))
        convs.append(_zeros(nn.Conv2d(d_model, out_channels, 3, padding=1)))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.dropout = nn.Dropout(dropout)
        self.to(dev)
        self.eval()

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        b, hh, ww, _ = x.shape
        pe = timestep_embedding(t, self.d_pos, stretch=1.0)[:, :, None, None]
        y = torch.cat([x.permute(0, 3, 1, 2), pe.expand(b, self.d_pos, hh, ww)], dim=1)
        y = self.convs[0](y)
        for i in range(self.num_layers):
            z = self.convs[2 * i + 1](F.silu(self.norms[2 * i](y)))
            z = self.dropout(F.silu(self.norms[2 * i + 1](z)))
            y = y + self.convs[2 * i + 2](z)
        y = self.convs[-1](F.silu(self.norms[-1](y)))
        return y.permute(0, 2, 3, 1)
