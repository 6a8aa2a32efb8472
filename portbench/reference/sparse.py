"""Plain PyTorch reference of the sparse space-time denoiser and its
training step (minecraft/sparse_diffusion.py:44-111, 400-501).

The denoiser sees ``num_context`` tokens of an S x H x W token volume: each
token's embedding (one extra row for the mask class) plus the sum of the
learned embeddings of its frame, row and column, then ``depth`` pre-norm
blocks of full softmax self-attention (one bias-free projection to q | k |
v, heads-major) and a GELU (tanh) MLP, LayerNorm eps 1e-6, and a linear
head on every token. A step: frames tokenised, a time per volume from the
loss-aware sampler, a window of frames that grows with the time
("neighbors"), ``num_context`` distinct positions drawn inside it, their
tokens corrupted, cross-entropy against the clean ones, then AdamW.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import tokenizer as ref_tok
from portbench.reference.m3 import attention
from portbench.reference.precision import Precision
from portbench.reference.train import corrupt

Params = Dict[str, torch.Tensor]


def neighbour_positions(r, offset_uniform, uniforms, num_context: int, shape):
    """The "neighbors" positions: a window of frames from ceil(N / (H W))
    frames at r = 0 towards the whole clip at r = 1 (capped at S - that
    minimum), placed at offset_uniform along the clip; the N positions whose
    ``uniforms`` rank lowest inside it (ties in position order)."""
    s, h, w = shape
    hw = h * w
    least = -(-num_context // hw)
    window = torch.floor(least + r.float().clamp(0, 1) * (s - least + 1))
    window = window.clamp(max=float(s - least))
    offset = torch.floor(offset_uniform.float() * (s - window + 1)).long() * hw
    pos = torch.arange(s * hw, device=r.device)
    keys = torch.where(pos[None] < (window.long() * hw)[:, None], uniforms, 2.0)
    return torch.argsort(keys, dim=-1, stable=True)[:, :num_context] + offset[:, None]


def denoiser_logits(p: Params, tokens, indices, cfg: Dict, prec: Precision):
    """(B, N) tokens at (B, N) flat positions -> (B, N, K) logits."""
    s, h, w = cfg["S"], cfg["H"], cfg["W"]
    x = (prec.embed(p["embedding.weight"], tokens)
         + (prec.embed(p["pos_emb_s.weight"], indices // (h * w))
            + prec.embed(p["pos_emb_h.weight"], (indices // w) % h)
            + prec.embed(p["pos_emb_w.weight"], indices % w)))
    dim = x.shape[-1]
    heads = cfg["heads"]
    everyone = torch.ones((1, 1), dtype=torch.bool, device=x.device)
    for i in range(cfg["depth"]):
        a = f"transformer.layers.{i}.0."
        xn = F.layer_norm(x, (dim,), p[a + "norm.weight"], p[a + "norm.bias"], eps=1e-6)
        q, k, v = prec.linear(xn, p[a + "fn.to_qkv.weight"]).chunk(3, dim=-1)
        o = attention(q, k, v, heads, everyone, prec)
        o = prec.linear(o, p[a + "fn.to_out.0.weight"], p[a + "fn.to_out.0.bias"])
        x = o + x
        m = f"transformer.layers.{i}.1."
        xn = F.layer_norm(x, (dim,), p[m + "norm.weight"], p[m + "norm.bias"], eps=1e-6)
        y = prec.linear(xn, p[m + "fn.net.0.weight"], p[m + "fn.net.0.bias"])
        y = prec.linear(F.gelu(y, approximate="tanh"), p[m + "fn.net.3.weight"],
                        p[m + "fn.net.3.bias"])
        x = y + x
    return prec.linear(x, p["logit_proj.weight"], p["logit_proj.bias"])


def encode_volume(tok: Params, frames: torch.Tensor, downscale_steps: int) -> torch.Tensor:
    """(B, S, H, W, C) uint8 frames -> (B, S, h, w) tokens."""
    b, s = frames.shape[:2]
    images = frames.reshape(b * s, *frames.shape[2:]).to(torch.float32) / 255.0
    toks = ref_tok.encode(tok, images, downscale_steps)
    return toks.reshape(b, s, *toks.shape[1:])


class TrainStep:
    """The loss of one training step on a step's inputs (``tokens``, the
    volume the reference encoded from the frames, and the draws), for
    ``train.run_steps``."""

    def __init__(self, cfg: Dict, prec: Precision):
        self.cfg, self.prec = cfg, prec

    def __call__(self, params: Params, step, sampler):
        cfg = self.cfg
        k = cfg["tokenizer"]["num_embeddings"]
        tokens = step["tokens"]
        b = tokens.shape[0]
        r = sampler.sample(step["gumbel"], step["jitter"])
        idx = neighbour_positions(r, step["offset_uniform"], step["position_uniform"],
                                  cfg["num_context"], (cfg["S"], cfg["H"], cfg["W"]))
        target = torch.gather(tokens.reshape(b, -1), 1, idx)
        corrupted = corrupt(target, r, step["mask_uniform"], step["resample_uniform"],
                            step["uniform_classes"], k, cfg["p_max_uniform"])
        logits = denoiser_logits(self.prec.cast(params), corrupted, idx, cfg, self.prec)
        ce = F.cross_entropy(logits.float().reshape(-1, k), target.reshape(-1),
                             reduction="none").reshape(b, -1)
        return ce.mean(), ce.mean(1), r


def param_spec(cfg: Dict) -> list:
    """(name, shape) of every parameter of the published sparse denoiser."""
    dim, mlp, heads = cfg["dim"], cfg["mlp_dim"], cfg["heads"]
    k = cfg["tokenizer"]["num_embeddings"]
    spec = [("pos_emb_s.weight", (cfg["S"], dim)), ("pos_emb_h.weight", (cfg["H"], dim)),
            ("pos_emb_w.weight", (cfg["W"], dim)), ("embedding.weight", (k + 1, dim))]
    for i in range(cfg["depth"]):
        a, m = f"transformer.layers.{i}.0.", f"transformer.layers.{i}.1."
        spec += [(a + "norm.weight", (dim,)), (a + "norm.bias", (dim,)),
                 (a + "fn.to_qkv.weight", (3 * dim, dim))]
        if heads != 1:
            spec += [(a + "fn.to_out.0.weight", (dim, dim)), (a + "fn.to_out.0.bias", (dim,))]
        spec += [(m + "norm.weight", (dim,)), (m + "norm.bias", (dim,)),
                 (m + "fn.net.0.weight", (mlp, dim)), (m + "fn.net.0.bias", (mlp,)),
                 (m + "fn.net.3.weight", (dim, mlp)), (m + "fn.net.3.bias", (dim,))]
    return spec + [("logit_proj.weight", (k, dim)), ("logit_proj.bias", (k,))]
