"""Continuous Gaussian DDPM: the cosine schedule, eps-prediction training
and the x0-reprojection sampler.

Port of ``world_modelz_tpu.diffusion.ddpm`` (reference:
som-diffusion/train_diffusion.py):
- the cosine alpha-bar schedule with s = 0.008 (:20-22);
- training: t ~ U[0, 1], x_t = sqrt(a) x0 + sqrt(1 - a) eps, MSE on eps
  (:115-127);
- sampling: the reference's reverse loop (:25-68): at each step re-noise
  the current x0 estimate at the schedule's time, predict eps, reproject to
  x0 and clip to [-1.25, 1.25], the alpha scaling skipped for the first 10%
  of the progress (:44-47, 54-57).

JAX's ``lax.scan`` over the timesteps is a Python loop here (one model call
a step) that keeps the evenly spaced trace JAX returns. The noise comes
from an explicit ``torch.Generator``, or is given (``noise``) so that tests
can feed JAX's draws.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

_S = 0.008


def alpha_bar(t: torch.Tensor) -> torch.Tensor:
    """Cosine cumulative signal level (train_diffusion.py:20-22)."""
    return torch.cos((t + _S) / (1 + _S) * math.pi * 0.5) ** 2


def ddpm_corrupt(
    x0: torch.Tensor, t: torch.Tensor, eps: Optional[torch.Tensor] = None, *,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward process: (x_t, eps) for times t (B,) or (B, 1),
    broadcast over x0's trailing dims (train_diffusion.py:115-124); eps is
    drawn from ``generator`` unless given."""
    a = alpha_bar(t.reshape(-1, *([1] * (x0.dim() - 1))))
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    return x0 * torch.sqrt(a) + eps * torch.sqrt(1.0 - a), eps


def trace_indices(timesteps: int, trace_steps: int) -> np.ndarray:
    """The steps the sampler's trace keeps: JAX's ``jnp.linspace(0,
    timesteps - 1, trace_steps).astype(int32)``, computed as jnp computes it
    (start (1 - i/div) + stop i/div in f32, the last exactly stop)."""
    stop = np.float32(timesteps - 1)
    if trace_steps == 1:
        return np.zeros(1, np.int64)
    div = trace_steps - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.concatenate([np.float32(0) * (np.float32(1) - step) + stop * step, [stop]])
    return out.astype(np.float32).astype(np.int32).astype(np.int64)


@torch.no_grad()
def ddpm_sample(
    eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    shape: Sequence[int],
    *,
    timesteps: int = 1000,
    trace_steps: int = 20,
    clip: float = 1.25,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Samples by the reference's x0-reprojection loop
    (train_diffusion.py:25-68).

    eps_fn: (x_t (B, ...), t (B, 1)) -> the eps prediction. ``noise``
    (timesteps, *shape): the step's normal draws, else drawn from
    ``generator`` (on ``device``, default the generator's). Returns the
    (trace_steps, *shape) trace of x0 estimates; the last is the sample."""
    shape = tuple(shape)
    if device is None:
        device = noise.device if noise is not None else (
            generator.device if generator is not None else "cpu")
    batch = shape[0]
    keep = trace_indices(timesteps, trace_steps)
    wanted = {int(i) for i in keep}
    kept = {}
    x0 = torch.zeros(shape, dtype=torch.float32, device=device)
    for step in range(timesteps):
        f = torch.tensor(step, dtype=torch.float32) / torch.tensor(timesteps - 1.0)
        t = torch.full((batch, 1), float(1.0 - f), dtype=torch.float32, device=device)
        a = alpha_bar(t.reshape(-1, *([1] * (len(shape) - 1))))
        eps = noise[step] if noise is not None else torch.randn(
            shape, generator=generator, device=device)
        # alpha scaling only after 10% progress (:44-47), compared in f32
        late = bool(f > torch.tensor(0.1, dtype=torch.float32))
        x = (x0 * torch.sqrt(a) if late else x0) + eps * torch.sqrt(1.0 - a)
        x0 = x - eps_fn(x, t) * torch.sqrt(1.0 - a)
        if late:
            x0 = x0 / torch.sqrt(a)
        x0 = torch.clamp(x0, -clip, clip)
        if step in wanted:
            kept[step] = x0
    return torch.stack([kept[int(i)] for i in keep])
