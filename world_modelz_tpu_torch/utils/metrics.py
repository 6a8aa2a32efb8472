"""Quantitative evaluation metrics (port of
``world_modelz_tpu.utils.metrics``):

- ``psnr``: peak signal-to-noise ratio, the batch mean.
- ``ssim``: structural similarity with a uniform 7 x 7 window.
- ``codebook_usage``: active-code fraction and perplexity from VQ
  activation counts.

Tensor functions on the inputs' device; each returns 0-d tensors.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean PSNR (dB) over the batch; inputs (B, ...) in [0, max_val]."""
    axes = tuple(range(1, a.ndim))
    mse = ((a - b) ** 2).mean(dim=axes)
    return (20.0 * torch.log10(torch.tensor(max_val, dtype=mse.dtype))
            - 10.0 * torch.log10(mse + 1e-12)).mean()


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over each size x size window (VALID) of the two spatial dims of
    (B, H, W, C)."""
    b, h, w, c = x.shape
    kernel = torch.full((1, 1, size, size), 1.0 / (size * size),
                        dtype=x.dtype, device=x.device)
    y = F.conv2d(x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w), kernel)
    return y.reshape(b, c, h - size + 1, -1).permute(0, 2, 3, 1)


def ssim(
    a: torch.Tensor,
    b: torch.Tensor,
    max_val: float = 1.0,
    window: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over a batch of (B, H, W, C) images (uniform window)."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a = _uniform_filter(a, window)
    mu_b = _uniform_filter(b, window)
    var_a = _uniform_filter(a * a, window) - mu_a**2
    var_b = _uniform_filter(b * b, window) - mu_b**2
    cov = _uniform_filter(a * b, window) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return s.mean()


def codebook_usage(activation_count: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Summary of VQ codebook health from (L, K) activation counts."""
    total = activation_count.sum(dim=-1, keepdim=True)
    p = activation_count / total.clamp_min(1)
    perplexity = torch.exp(-(p * torch.log(p + 1e-10)).sum(dim=-1))  # per latent
    active = (activation_count > 0).to(torch.float32).mean(dim=-1)
    return {
        "perplexity": perplexity.mean(),
        "active_fraction": active.mean(),
    }
