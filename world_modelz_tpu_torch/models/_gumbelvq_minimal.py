"""Minimal GumbelVQ: an interface-compatible stand-in for taming's.

The port's own copy of ``world_modelz_tpu.models._gumbelvq_minimal`` (the
port imports nothing of the JAX package; that module was torch already).
The Sber variant of the reference loads a pretrained taming-transformers
``GumbelVQ`` VQGAN (minecraft/sparse_diffusion_sber.py:23-49) and uses
three entry points: ``model.encode(x)[2][2]`` flat token indices,
``model.quantize.get_codebook_entry(indices, (b, h, w, c))`` and
``model.decode(z)`` (:162-164, :452-453). Without the ``taming`` package,
``models.external.TamingGumbelVQAdapter`` builds this implementation of
the published architecture (conv encoder and decoder, a Gumbel-softmax
codebook), so the adapter's whole path (config, construction, checkpoint
load, NHWC and range marshalling, encode and decode) runs; only
pretrained weights are not exercised. A real taming checkpoint whose
config matches loads into the parameters whose names and shapes agree
(``strict=False``); bit parity with taming is not claimed.

It differs from the JAX package's copy only where the device needs it: the
codec may sit on any device, and its tensors follow its parameters'; and a
machine without PyYAML reads a config written as JSON (``load_config``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(num_groups=min(8, c), num_channels=c)


class Encoder(nn.Module):
    """conv3x3 -> [GroupNorm, SiLU, conv4x4 stride 2] per extra ch_mult
    level -> GroupNorm, SiLU, conv1x1 to z_channels."""

    def __init__(self, in_channels: int, ch: int, ch_mult, z_channels: int):
        super().__init__()
        layers = [nn.Conv2d(in_channels, ch * ch_mult[0], 3, padding=1)]
        prev = ch * ch_mult[0]
        for mult in ch_mult[1:]:
            cur = ch * mult
            layers += [_norm(prev), nn.SiLU(), nn.Conv2d(prev, cur, 4, stride=2, padding=1)]
            prev = cur
        layers += [_norm(prev), nn.SiLU(), nn.Conv2d(prev, z_channels, 1)]
        self.net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Decoder(nn.Module):
    """The encoder mirrored with transposed convs; tanh output in [-1, 1]."""

    def __init__(self, ch: int, ch_mult, z_channels: int, out_ch: int):
        super().__init__()
        mults = tuple(reversed(ch_mult))
        prev = ch * mults[0]
        layers = [nn.Conv2d(z_channels, prev, 3, padding=1)]
        for mult in mults[1:]:
            cur = ch * mult
            layers += [_norm(prev), nn.SiLU(),
                       nn.ConvTranspose2d(prev, cur, 4, stride=2, padding=1)]
            prev = cur
        layers += [_norm(prev), nn.SiLU(), nn.Conv2d(prev, out_ch, 3, padding=1), nn.Tanh()]
        self.net = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.net(z)


class GumbelQuantize(nn.Module):
    """proj -> (a hard Gumbel sample in training, the argmax in eval) ->
    embedding lookup."""

    def __init__(self, z_channels: int, n_embed: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(z_channels, n_embed, 1)
        self.embed = nn.Embedding(n_embed, embed_dim)

    def forward(self, h: torch.Tensor):
        logits = self.proj(h)  # (B, K, h, w)
        if self.training:
            soft = F.gumbel_softmax(logits, tau=1.0, dim=1, hard=True)
            z_q = torch.einsum("bkhw,kd->bdhw", soft, self.embed.weight)
            indices = soft.argmax(dim=1)
        else:
            indices = logits.argmax(dim=1)  # (B, h, w)
            z_q = self.embed(indices).permute(0, 3, 1, 2)
        diff = torch.zeros((), device=h.device)
        return z_q, diff, (None, None, indices.reshape(-1))

    def get_codebook_entry(self, indices: torch.Tensor, shape) -> torch.Tensor:
        """taming's shape spec (B, H, W, C) (sparse_diffusion_sber.py:162)."""
        b, h, w, _c = shape
        z_q = self.embed(indices.reshape(b, h, w))
        return z_q.permute(0, 3, 1, 2).contiguous()


class MinimalGumbelVQ(nn.Module):
    def __init__(self, ddconfig: Dict[str, Any], n_embed: int, embed_dim: int):
        super().__init__()
        ch = int(ddconfig.get("ch", 64))
        ch_mult = tuple(ddconfig.get("ch_mult", (1, 2, 4)))
        z_channels = int(ddconfig["z_channels"])
        self.encoder = Encoder(int(ddconfig.get("in_channels", 3)), ch, ch_mult, z_channels)
        self.decoder = Decoder(ch, ch_mult, z_channels, int(ddconfig.get("out_ch", 3)))
        self.quantize = GumbelQuantize(z_channels, n_embed, embed_dim)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    def encode(self, x: torch.Tensor):
        return self.quantize(self.encoder(x))

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z_q))

    def load_state_dict(self, sd, strict: bool = False):
        """Best effort: keep the entries whose name and shape match."""
        own = super().state_dict()
        kept = {k: v for k, v in sd.items()
                if k in own and tuple(v.shape) == tuple(own[k].shape)}
        return super().load_state_dict(kept, strict=False)


def build(ddconfig: Dict[str, Any], n_embed: int, embed_dim: int, **_unused) -> MinimalGumbelVQ:
    """The minimal GumbelVQ from a taming-style config mapping; the other
    keys of taming's configs (kl_weight, temperature scheduling, the loss
    config, ...) are accepted and ignored, so real config yamls parse."""
    return MinimalGumbelVQ(ddconfig, int(n_embed), int(embed_dim))


class AttrDict(dict):
    """A yaml mapping with attribute access (config loads without
    omegaconf)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return AttrDict(v) if isinstance(v, dict) else v


def load_config(path: str) -> AttrDict:
    """A yaml config; without PyYAML installed, a config written as JSON
    (which is yaml) is read with ``json``."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        import json

        return AttrDict(json.loads(text))
    return AttrDict(yaml.safe_load(text))
