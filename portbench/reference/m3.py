"""Plain PyTorch reference of the m3 masked video-diffusion denoiser and
its training step (vq-video-diffusion/results/README.md "model #3";
minecraft/main2.py:26-37, 199-279; local_3d_attention.py).

The denoiser: a token embedding with one extra row for the mask class,
the sum of learned frame, row and column embeddings, ``depth`` pre-norm
residual blocks of windowed space-time attention (keys within
``extents`` frames, rows and columns of the query, clipped at the clip's
edges; the published block normalises the keys and values' input but feeds
the queries' projection the un-normalised stream) and a GELU (tanh) MLP,
LayerNorm eps 1e-6, and a linear head on the last frame. Parameters are
read by their published state_dict names.

A training step (main2.py:251-279): frames composited from sprites,
tokenised by the frozen tokenizer, a diffusion time per clip from the
loss-aware sampler, the last frame corrupted, cross-entropy of the head's
logits against the clean last frame, then AdamW.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import tokenizer as ref_tok
from portbench.reference.precision import Precision
from portbench.reference.train import corrupt

Params = Dict[str, torch.Tensor]


def window_mask(shape: Tuple[int, int, int], extents: Tuple[int, int, int],
                device) -> torch.Tensor:
    """(L, L) bool over the clip's L = S H W positions: True where the key
    lies within the query's window."""
    s, h, w = shape
    grid = torch.stack(torch.meshgrid(
        torch.arange(s), torch.arange(h), torch.arange(w), indexing="ij"), -1).reshape(-1, 3)
    d = (grid[:, None, :] - grid[None, :, :]).abs()
    ext = torch.tensor(extents)
    return (d <= ext).all(-1).to(device)


def attention(q, k, v, heads: int, allowed: torch.Tensor, prec: Precision):
    """Softmax attention of (B, L, heads * dh) queries over keys where
    ``allowed`` (L, L) holds; scores and softmax in float32, the weights
    cast to the values' dtype for their product."""
    b, n, inner = q.shape
    dh = inner // heads

    def split(t):
        return t.reshape(b, -1, heads, dh).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    scores = torch.matmul(prec.operand(qh).float(), prec.operand(kh).float().transpose(-1, -2))
    scores = scores * dh ** -0.5
    scores = scores.masked_fill(~allowed, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(vh.dtype)
    out = torch.matmul(prec.operand(weights), prec.operand(vh))
    return out.transpose(1, 2).reshape(b, n, inner)


def denoiser_logits(p: Params, tokens: torch.Tensor, cfg: Dict, prec: Precision,
                    allowed: torch.Tensor) -> torch.Tensor:
    """(B, S, H, W) tokens -> (B, H, W, K) logits of the last frame, in the
    parameters' dtype."""
    b, s, h, w = tokens.shape
    pre = "transformer."
    dev = tokens.device
    pos = (prec.embed(p[pre + "pos_emb_s.weight"], torch.arange(s, device=dev))[:, None, None, :]
           + prec.embed(p[pre + "pos_emb_h.weight"], torch.arange(h, device=dev))[None, :, None, :]
           + prec.embed(p[pre + "pos_emb_w.weight"], torch.arange(w, device=dev))[None, None, :, :])
    x = prec.embed(p[pre + "embedding.weight"], tokens) + pos[None]
    x = x.reshape(b, s * h * w, -1)
    dim = x.shape[-1]
    for i in range(cfg["depth"]):
        a = f"{pre}layers.{i}.0."
        xn = F.layer_norm(x, (dim,), p[a + "norm.weight"], p[a + "norm.bias"], eps=1e-6)
        q = prec.linear(x, p[a + "fn.to_q.weight"])
        k = prec.linear(xn, p[a + "fn.to_k.weight"])
        v = prec.linear(xn, p[a + "fn.to_v.weight"], p[a + "fn.to_v.bias"])
        o = attention(q, k, v, cfg["heads"], allowed, prec)
        if a + "fn.to_out.0.weight" in p:
            o = prec.linear(o, p[a + "fn.to_out.0.weight"], p[a + "fn.to_out.0.bias"])
        x = o + x
        m = f"{pre}layers.{i}.1."
        xn = F.layer_norm(x, (dim,), p[m + "norm.weight"], p[m + "norm.bias"], eps=1e-6)
        y = prec.linear(xn, p[m + "fn.net.0.weight"], p[m + "fn.net.0.bias"])
        y = prec.linear(F.gelu(y, approximate="tanh"), p[m + "fn.net.3.weight"],
                        p[m + "fn.net.3.bias"])
        x = y + x
    last = x.reshape(b, s, h, w, dim)[:, -1]
    return prec.linear(last, p["logit_proj.weight"], p["logit_proj.bias"])


class TrainStep:
    """The loss of one training step on a step's inputs (``sprites``,
    ``pos`` and the draws), for ``train.run_steps``."""

    def __init__(self, cfg: Dict, tok_params: Params, prec: Precision, device):
        self.cfg, self.prec = cfg, prec
        self.tok = ref_tok.round_bf16(tok_params) if cfg.get("tok_bf16") else tok_params
        grid = cfg["image_size"] // 2 ** cfg["tokenizer"]["downscale_steps"]
        self.shape = (cfg["n_past"] + 1, grid, grid)
        self.allowed = window_mask(self.shape, tuple(cfg["extents"]), device)

    def tokens(self, step) -> torch.Tensor:
        frames = ref_tok.composite(step["sprites"], step["pos"], self.cfg["image_size"])
        b, s = frames.shape[:2]
        toks = ref_tok.encode(self.tok, frames.reshape(b * s, *frames.shape[2:]),
                              self.cfg["tokenizer"]["downscale_steps"])
        return toks.reshape(b, s, *toks.shape[1:])

    def __call__(self, params: Params, step, sampler):
        cfg = self.cfg
        k = cfg["tokenizer"]["num_embeddings"]
        tokens = self.tokens(step)
        b = tokens.shape[0]
        target = tokens[:, -1].reshape(b, -1)
        r = sampler.sample(step["gumbel"], step["jitter"])
        corrupted = corrupt(target, r, step["mask_uniform"], step["resample_uniform"],
                            step["uniform_classes"], k, cfg["p_max_uniform"])
        z = tokens.clone()
        z[:, -1] = corrupted.reshape(z[:, -1].shape)
        logits = denoiser_logits(self.prec.cast(params), z, cfg, self.prec, self.allowed)
        ce = F.cross_entropy(logits.float().reshape(-1, k), target.reshape(-1),
                             reduction="none").reshape(b, -1)
        return ce.mean(), ce.mean(1), r


def param_spec(cfg: Dict) -> list:
    """(name, shape) of every parameter of the published denoiser."""
    dim, inner, mlp = cfg["dim"], cfg["heads"] * cfg["dim_head"], cfg["mlp_dim"]
    k = cfg["tokenizer"]["num_embeddings"]
    grid = cfg["image_size"] // 2 ** cfg["tokenizer"]["downscale_steps"]
    pre = "transformer."
    spec = [(pre + "embedding.weight", (k + 1, dim)),
            (pre + "pos_emb_s.weight", (cfg["n_past"] + 1, dim)),
            (pre + "pos_emb_h.weight", (grid, dim)), (pre + "pos_emb_w.weight", (grid, dim))]
    for i in range(cfg["depth"]):
        a, m = f"{pre}layers.{i}.0.", f"{pre}layers.{i}.1."
        spec += [(a + "norm.weight", (dim,)), (a + "norm.bias", (dim,)),
                 (a + "fn.to_q.weight", (inner, dim)), (a + "fn.to_k.weight", (inner, dim)),
                 (a + "fn.to_v.weight", (inner, dim)), (a + "fn.to_v.bias", (inner,))]
        if not (cfg["heads"] == 1 and cfg["dim_head"] == dim):
            spec += [(a + "fn.to_out.0.weight", (dim, inner)), (a + "fn.to_out.0.bias", (dim,))]
        spec += [(m + "norm.weight", (dim,)), (m + "norm.bias", (dim,)),
                 (m + "fn.net.0.weight", (mlp, dim)), (m + "fn.net.0.bias", (mlp,)),
                 (m + "fn.net.3.weight", (dim, mlp)), (m + "fn.net.3.bias", (dim,))]
    return spec + [("logit_proj.weight", (k, dim)), ("logit_proj.bias", (k,))]
