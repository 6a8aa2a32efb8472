"""Plain PyTorch reference of SDAR's block-diffusion MoE decoder at one
card's share of an expert-parallel layer, and its BD3-LM training step
(JetLM/SDAR-30B-A3B-Chat's config.json; the Qwen3-MoE block it was
converted from; Arriola et al., arXiv:2503.09573, section 3.2).

A layer: x + o_proj(attn(rope(q_norm(q_proj h)), rope(k_norm(k_proj h)),
v_proj h)) with h = RMSNorm(x), grouped-query attention (8 query heads a
KV head) under the block-diffusion mask; then x + the held experts' part of
the MoE over RMSNorm(x): the f32 softmax of the router's f32 product over
all experts,
its top k renormalised, each token through each of its selected held
experts, one expert at a time, SwiGLU down(silu(gate h) up h), weighted
and summed in f32. The final RMSNorm and the untied head on the noisy half.

The mask is built from its three rules as a matrix (not from the program's
predicate): a noisy block sees itself and the clean blocks before it; a
clean block sees the clean blocks up to itself; nothing sees a noisy block
from outside it. Attention runs a query block at a time under
``torch.utils.checkpoint`` and each layer is checkpointed too, so that
8,192 positions fit.

The loss: x_t from the step's draws (t = 1 - u per block, a token masked
where its uniform is under t), the cross-entropy of the noisy half's logits
at the masked positions weighted 1 / t, summed, over B L.

``variant`` plants the faults a cell's limits must catch: ``drop_last``
(each token's last selected expert left out: top-7 of top-8), ``capacity`` 1.0 (each expert keeps
the first capacity x T k / E of its assignments in token order), and
``noisy_bidirectional`` (the noisy blocks see each other).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.precision import Precision

Params = Dict[str, torch.Tensor]
QUERY_BLOCK = 512


def block_mask(seq_len: int, block: int, device, noisy_bidirectional: bool = False
               ) -> torch.Tensor:
    """(2 L, 2 L) bool: which key each query of [x_t ; x_0] sees."""
    blk = torch.arange(seq_len, device=device) // block
    same = blk[:, None] == blk[None, :]
    before = blk[None, :] < blk[:, None]
    noisy_noisy = torch.ones_like(same) if noisy_bidirectional else same
    noisy_clean = before
    clean_noisy = torch.zeros_like(same)
    clean_clean = before | same
    return torch.cat([torch.cat([noisy_noisy, noisy_clean], 1),
                      torch.cat([clean_noisy, clean_clean], 1)], 0)


def rms_norm(x, w, eps):
    xf = x.float()
    return w * (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


def rope(x, cos, sin):
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], -1) * sin


def _attend(q, k, v, allowed, prec: Precision):
    """(H, Q, dh) queries over (H, N, dh) keys and values where ``allowed``
    (Q, N) holds: scores and softmax in f32, the weights cast to the
    values' dtype for their product."""
    s = torch.matmul(prec.operand(q).float(), prec.operand(k).float().transpose(-1, -2))
    s = (s * q.shape[-1] ** -0.5).masked_fill(~allowed, float("-inf"))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(prec.operand(w), prec.operand(v))


def attention(q, k, v, allowed, prec: Precision):
    """(B, N, Hq, dh) q, (B, N, Hkv, dh) k and v -> (B, N, Hq dh), each query
    block of each row under a checkpoint."""
    b, n, hq, dh = q.shape
    group = hq // k.shape[2]
    out = []
    for i in range(b):
        kh = k[i].transpose(0, 1).repeat_interleave(group, 0)
        vh = v[i].transpose(0, 1).repeat_interleave(group, 0)
        qh = q[i].transpose(0, 1)
        rows = [checkpoint(_attend, qh[:, r:r + QUERY_BLOCK], kh, vh,
                           allowed[r:r + QUERY_BLOCK], prec, use_reentrant=False)
                for r in range(0, n, QUERY_BLOCK)]
        out.append(torch.cat(rows, 1).transpose(0, 1).reshape(n, hq * dh))
    return torch.stack(out)


def experts(p: Params, pre: str, x, cfg: Dict, prec: Precision, variant: Dict):
    """The held experts' weighted SwiGLU outputs for (T, D) x, summed in f32."""
    k, inter = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    held = cfg["num_experts"]
    first = cfg.get("expert_rank", 0) * held
    probs = torch.softmax(F.linear(x.float(), p[pre + "gate.weight"].float()), dim=-1)
    weights, index = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        weights = weights / weights.sum(-1, keepdim=True)
    if variant.get("drop_last"):
        weights, index = weights[:, :-1], index[:, :-1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    gate_up, down = p[pre + "experts.gate_up"], p[pre + "experts.down"]
    cap = None
    if variant.get("capacity"):
        cap = math.ceil(variant["capacity"] * x.shape[0] * k / cfg["router_experts"])
    for j in range(held):
        tok, slot = (index == first + j).nonzero(as_tuple=True)
        if cap is not None:
            order = torch.argsort(tok, stable=True)[:cap]
            tok, slot = tok[order], slot[order]
        if tok.numel() == 0:  # no token here: the expert's gradient is zero
            out = out + 0.0 * (gate_up[j].sum() + down[j].sum()).float()
            continue
        xe = x[tok]
        g = prec.linear(xe, gate_up[j, :inter])
        u = prec.linear(xe, gate_up[j, inter:])
        y = prec.linear(F.silu(g) * u, down[j])
        out = out.index_add(0, tok, y.float() * weights[tok, slot][:, None])
    return out.to(x.dtype)


def layer(p: Params, i: int, x, cos, sin, allowed, cfg: Dict, prec: Precision, variant: Dict):
    pre = f"model.layers.{i}."
    eps = cfg["rms_norm_eps"]
    b, n, d = x.shape
    hq, hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    a = pre + "self_attn."
    h = rms_norm(x, p[pre + "input_layernorm.weight"], eps)
    q = rms_norm(prec.linear(h, p[a + "q_proj.weight"]).view(b, n, hq, dh),
                 p[a + "q_norm.weight"], eps)
    k = rms_norm(prec.linear(h, p[a + "k_proj.weight"]).view(b, n, hkv, dh),
                 p[a + "k_norm.weight"], eps)
    v = prec.linear(h, p[a + "v_proj.weight"]).view(b, n, hkv, dh)
    o = attention(rope(q, cos, sin), rope(k, cos, sin), v, allowed, prec)
    x = x + prec.linear(o, p[a + "o_proj.weight"])
    h = rms_norm(x, p[pre + "post_attention_layernorm.weight"], eps)
    return x + experts(p, pre + "mlp.", h.reshape(b * n, d), cfg, prec, variant).view(b, n, d)


def logits(p: Params, tokens, cfg: Dict, prec: Precision, variant: Optional[Dict] = None):
    """(B, 2 L) tokens of [x_t ; x_0] -> (B, L, V) logits of the noisy half."""
    variant = variant or {}
    b, n = tokens.shape
    half = n // 2
    dh = cfg["head_dim"]
    x = prec.embed(p["model.embed_tokens.weight"], tokens)
    pos = (torch.arange(n, device=tokens.device) % half).float()
    inv = 1.0 / cfg["rope_theta"] ** (torch.arange(0, dh, 2, device=tokens.device).float() / dh)
    emb = torch.cat([pos[:, None] * inv, pos[:, None] * inv], -1)
    cos, sin = emb.cos().to(x.dtype)[:, None], emb.sin().to(x.dtype)[:, None]
    allowed = block_mask(half, cfg["block"], tokens.device,
                         variant.get("noisy_bidirectional", False))
    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(layer, p, i, x, cos, sin, allowed, cfg, prec, variant,
                       use_reentrant=False)
    x = rms_norm(x[:, :half], p["model.norm.weight"], cfg["rms_norm_eps"])
    return prec.linear(x, p["lm_head.weight"])


class NoSampler:
    """The block-diffusion step draws no diffusion time from a sampler."""

    def update(self, r, losses) -> None:
        pass


class TrainStep:
    """The loss of one step on its inputs (``x0`` (B, L) and the draws
    ``block_uniform`` (B, L / block), ``token_uniform`` (B, L)), for
    ``train.run_steps``."""

    def __init__(self, cfg: Dict, prec: Precision, variant: Optional[Dict] = None):
        self.cfg, self.prec, self.variant = cfg, prec, variant or {}

    def __call__(self, params: Params, step, sampler):
        cfg = self.cfg
        x0 = step["x0"]
        t = (1.0 - step["block_uniform"]).repeat_interleave(cfg["block"], dim=1)
        masked = step["token_uniform"] < t
        xt = torch.where(masked, cfg["vocab_size"] - 1, x0)
        out = logits(self.prec.cast(params), torch.cat([xt, x0], 1), cfg, self.prec,
                     self.variant)
        ce = F.cross_entropy(out.float().reshape(-1, out.shape[-1]), x0.reshape(-1),
                             reduction="none").reshape(x0.shape)
        loss = torch.where(masked, ce / t, 0.0).sum() / x0.numel()
        return loss, loss.detach()[None], t[:, 0]


def param_spec(cfg: Dict) -> list:
    """(name, shape) of every parameter of the card's share."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    hq, hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    held, inter = cfg["num_experts"], cfg["moe_intermediate_size"]
    spec = [("model.embed_tokens.weight", (v, d))]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        a = pre + "self_attn."
        spec += [(pre + "input_layernorm.weight", (d,)),
                 (a + "q_proj.weight", (hq * dh, d)), (a + "k_proj.weight", (hkv * dh, d)),
                 (a + "v_proj.weight", (hkv * dh, d)), (a + "o_proj.weight", (d, hq * dh)),
                 (a + "q_norm.weight", (dh,)), (a + "k_norm.weight", (dh,)),
                 (pre + "post_attention_layernorm.weight", (d,)),
                 (pre + "mlp.gate.weight", (cfg["router_experts"], d)),
                 (pre + "mlp.experts.gate_up", (held, 2 * inter, d)),
                 (pre + "mlp.experts.down", (held, d, inter))]
    return spec + [("model.norm.weight", (d,)), ("lm_head.weight", (v, d))]
