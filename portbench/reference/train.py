"""Plain PyTorch pieces of a masked-diffusion training step shared by the
trainers' references: the loss-aware diffusion-time sampler
(minecraft/importance_sampling.py), the token corruption
(vq-video-diffusion/main.py:246-259), the warmup-cosine learning rate,
AdamW as optax applies it, and the loop that runs steps and collects what
the comparison reads.

Every random number comes in through the step's draws, so the reference
and the program see the same ones.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

Params = Dict[str, torch.Tensor]


class LossAwareSampler:
    """100 buckets over r in [0, 1): an EMA (0.9) of each bucket's
    per-sample losses, sampled in proportion (mixed with a 1% uniform floor)
    once every bucket has seen more than 10 samples, uniform before."""

    def __init__(self, device, buckets: int = 100, uniform_p: float = 0.01,
                 alpha: float = 0.9, warmup: int = 10):
        self.weights = [1.0] * buckets
        self.counts = [0] * buckets
        self.n, self.uniform_p, self.alpha, self.warmup = buckets, uniform_p, alpha, warmup
        self.device = device

    def probabilities(self) -> torch.Tensor:
        if all(c > self.warmup for c in self.counts):
            w = torch.tensor(self.weights, dtype=torch.float64)
            w = (1.0 - self.uniform_p) * w / w.sum() + self.uniform_p / self.n
        else:
            w = torch.full((self.n,), 1.0 / self.n, dtype=torch.float64)
        return w.to(torch.float32).to(self.device)

    def sample(self, gumbel: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
        """Buckets argmax(log w + Gumbel) (a categorical draw), then r =
        (bucket + jitter) / n."""
        bucket = (torch.log(self.probabilities() + 1e-20) + gumbel).argmax(-1)
        return (bucket.to(torch.float32) + jitter) / self.n

    def update(self, r: torch.Tensor, losses: torch.Tensor) -> None:
        """Each sample's loss into its bucket's EMA, in batch order."""
        for t, loss in zip(r.tolist(), losses.tolist()):
            i = min(max(int(t * self.n), 0), self.n - 1)
            self.weights[i] = self.alpha * self.weights[i] + (1.0 - self.alpha) * loss
            self.counts[i] += 1


def corrupt(tokens, r, mask_uniform, resample_uniform, uniform_classes,
            num_classes: int, p_max_uniform: float):
    """(B, N) clean tokens -> corrupted: resampled to ``uniform_classes``
    where resample_uniform < r p_max_uniform, then masked (the token
    ``num_classes``) where mask_uniform < r."""
    r = r.reshape(-1, 1)
    out = torch.where(resample_uniform < r * p_max_uniform, uniform_classes, tokens)
    return torch.where(mask_uniform < r, num_classes, out)


def learning_rate(step: int, base: float, warmup: int, total: int) -> float:
    """Linear warmup from 0 over ``warmup`` updates, then a cosine to 0 over
    ``total`` more; ``step`` counts the updates applied before this one."""
    if step < warmup:
        return base * step / warmup
    frac = min(step - warmup, total) / total
    return base * 0.5 * (1.0 + math.cos(math.pi * frac))


class AdamW:
    """optax.adamw (b1 0.9, b2 0.999, eps 1e-8) on f32 parameters, with the
    learning rate of ``learning_rate``; a step whose loss or gradient norm
    is not finite leaves everything as it was."""

    def __init__(self, params: Params, lr: float, warmup: int, total: int,
                 weight_decay: float):
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0
        self.lr, self.warmup, self.total, self.wd = lr, warmup, total, weight_decay

    @torch.no_grad()
    def step(self, params: Params, grads: Params, ok: bool) -> None:
        if not ok:
            return
        lr = learning_rate(self.count, self.lr, self.warmup, self.total)
        c = self.count + 1
        for n, p in params.items():
            g = torch.nan_to_num(grads[n])
            self.mu[n] = 0.1 * g + 0.9 * self.mu[n]
            self.nu[n] = 0.001 * g * g + 0.999 * self.nu[n]
            u = (self.mu[n] / (1 - 0.9 ** c)) / (torch.sqrt(self.nu[n] / (1 - 0.999 ** c)) + 1e-8)
            p.sub_(lr * (u + self.wd * p))
        self.count = c


def run_steps(params: Params, steps: List, loss_fn: Callable, opt: AdamW,
              sampler: LossAwareSampler) -> Dict:
    """Run one training step per entry of ``steps`` on the f32 masters
    ``params`` (updated in place). ``loss_fn(params, step, sampler)``
    returns (mean loss, per-sample losses, r). Returns each step's loss and
    gradient norm, each leaf's gradient norm at the first step, and each
    leaf's change over all the steps."""
    start = {n: p.detach().clone() for n, p in params.items()}
    losses, norms, first = [], [], None
    for i, step in enumerate(steps):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        loss, per_sample, r = loss_fn(params, step, sampler)
        loss.backward()
        grads = {n: p.grad.detach().float() for n, p in params.items()}
        for p in params.values():
            p.requires_grad_(False)
        gn = torch.sqrt(sum((g * g).sum() for g in grads.values())).item()
        ok = math.isfinite(loss.item()) and math.isfinite(gn)
        if i == 0:
            first = {n: torch.linalg.vector_norm(g).item() for n, g in grads.items()}
        opt.step(params, grads, ok)
        if ok:
            sampler.update(r.detach(), torch.nan_to_num(per_sample.detach()))
        losses.append(loss.item())
        norms.append(gn)
    change = {n: torch.linalg.vector_norm(params[n] - start[n]).item() for n in params}
    return {"loss": losses, "grad_norm": norms, "grad1": first, "change": change}
