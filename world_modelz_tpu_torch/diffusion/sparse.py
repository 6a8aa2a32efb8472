"""Sparse space-time diffusion: position sampling and volume denoising.

Port of ``world_modelz_tpu.diffusion.sparse`` (reference:
minecraft/sparse_diffusion.py):
- ``sample_flat_positions`` (:31-41): uniform token subsets without
  replacement, one independent sample per row (the JAX package's
  documented deviation from the reference's shared permutation).
- ``sample_time_dependent`` (:44-72): diffusion-time-conditioned temporal
  windows; for small t the positions come from a narrow band of frames,
  approaching the whole clip as t -> 1.
- ``sparse_denoise_volume`` (:139-202): the evaluation sweep that covers
  the S * H * W volume in ``num_context`` chunks per iteration, scattering
  the draws back.

Sampling without replacement is the JAX package's fixed-shape argsort:
uniform keys, positions outside the window pushed to 2.0, a stable sort
(``jnp.argsort`` is stable; ties at 2.0 keep position order). The window
arithmetic is float32, as in JAX. Randomness is explicit: each function
takes its uniforms (and the sweep its permutations and Gumbel noise) as
tensors, drawn from a ``torch.Generator`` when not given, so the tests can
replay JAX's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# tokens (B, N), flat positions (B, N) -> logits (B, N, K)
LogitsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def sample_flat_positions(
    batch_size: int,
    context_length: int,
    volume: int,
    *,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """(B, N) distinct flat positions drawn uniformly from [0, volume),
    independently per row: the first ``context_length`` ranks of
    ``uniforms`` (B, volume)."""
    if uniforms is None:
        uniforms = torch.rand(
            (batch_size, volume), generator=generator, device=device)
    return torch.argsort(uniforms, dim=-1, stable=True)[:, :context_length]


def sample_time_dependent(
    batch_size: int,
    context_length: int,
    shape: Tuple[int, int, int],
    t: torch.Tensor,
    o: Optional[torch.Tensor] = None,
    *,
    offset_uniform: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Positions from a diffusion-time-dependent temporal window.

    The window (in frames) grows from ceil(N / (H * W)) to the whole clip
    as t -> 1; its offset is ``o`` (the sweep's fractions, clipped to
    [0, 1 - 1e-5]) or, when ``o`` is None, the uniforms ``offset_uniform``
    (B,); the positions inside it are drawn without replacement through
    ``uniforms`` (B, volume).

    Args:
      t: (B,) diffusion times.

    Returns:
      (B, context_length) int64 flat positions into the S * H * W volume.
    """
    s, h, w = shape
    hw = h * w
    volume = s * hw
    dev = t.device
    t = t.reshape(-1).to(torch.float32).clamp(0.0, 1.0)
    min_window = -(-context_length // hw)  # ceil
    if not min_window < s:
        raise ValueError(
            f"context_length {context_length} needs more than the {s} "
            "available frames")
    window = torch.floor(min_window + t * (s - min_window + 1))
    window = torch.clamp(window, max=float(s - min_window))  # (:59)
    if o is None:
        if offset_uniform is None:
            offset_uniform = torch.rand(
                (batch_size,), generator=generator, device=dev)
        o = offset_uniform.reshape(-1).to(torch.float32)
    else:
        o = o.reshape(-1).to(torch.float32).clamp(0.0, 1.0 - 1e-5)
    offset = torch.floor(o * (s - window + 1)).to(torch.int64) * hw
    window_tokens = window.to(torch.int64) * hw
    if uniforms is None:
        uniforms = torch.rand((batch_size, volume), generator=generator, device=dev)
    pos = torch.arange(volume, device=dev)
    # positions beyond the window sort last; the first context_length ranks
    # are a uniform sample without replacement from [0, window)
    keys = torch.where(pos[None] < window_tokens[:, None], uniforms, 2.0)
    picks = torch.argsort(keys, dim=-1, stable=True)[:, :context_length]
    return picks + offset[:, None]


@dataclasses.dataclass
class ChunkDraws:
    """The random numbers of one chunk of the sweep."""

    positions: Optional[torch.Tensor]  # (B, volume) window uniforms ("neighbors")
    mask: torch.Tensor  # (B, N) re-mask uniforms
    gumbel: torch.Tensor  # (B, N, K) standard Gumbel noise of the draw


class GeneratorDraws:
    """The sweep's draws from ``generator`` (on its device): per iteration
    the rows' permutations of the volume ("uniform" sweeps only) and the
    chunk order; per chunk its ``ChunkDraws``. A test replays another
    source through the same two methods."""

    def __init__(self, generator: torch.Generator, batch_size: int,
                 volume: int, num_context: int, num_classes: int,
                 sampling_type: str):
        self.gen, self.b, self.volume = generator, batch_size, volume
        self.n, self.k, self.sampling_type = num_context, num_classes, sampling_type
        self.offset_count = volume // num_context + 1

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.gen.device)

    def iteration(self, i: int) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        perm = None
        if self.sampling_type == "uniform":
            perm = torch.argsort(self._rand(self.b, self.volume), dim=-1)
        order = torch.randperm(
            self.offset_count, generator=self.gen, device=self.gen.device)
        return perm, order

    def chunk(self, i: int, k: int) -> ChunkDraws:
        positions = None
        if self.sampling_type == "neighbors":
            positions = self._rand(self.b, self.volume)
        mask = self._rand(self.b, self.n)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(self._rand(self.b, self.n, self.k).clamp_min(tiny)))
        return ChunkDraws(positions, mask, gumbel)


@torch.no_grad()
def sparse_denoise_volume(
    logits_fn: LogitsFn,
    *,
    batch_size: int,
    shape: Tuple[int, int, int],
    num_classes: int,
    mask_token: int,
    num_context: int = 512,
    num_iterations: int = 100,
    sampling_type: str = "neighbors",
    device=None,
    generator: Optional[torch.Generator] = None,
    draws=None,
) -> torch.Tensor:
    """Generate a full token volume by sparse chunked denoising.

    Start all-mask; for each of ``num_iterations`` rounds, sweep the volume
    in ``num_context`` chunks (``volume // num_context + 1`` chunk offsets
    in a random order), re-mask a ``1 - alpha`` fraction of each chunk,
    draw replacements from the model (argmax of logits + Gumbel, as
    ``jax.random.categorical``) and scatter them back. The "uniform" sweep
    strides ``num_context`` through one permutation per round (the JAX
    package's fix of the reference's empty chunks).

    Draws come from ``draws`` (an object with the methods of
    ``GeneratorDraws``) when given, else from ``generator`` (a fresh one
    seeded 0 on ``device`` when neither is given).

    Returns:
      (B, S, H, W) int64 token volume (entries < num_classes).
    """
    if sampling_type not in ("uniform", "neighbors"):
        raise ValueError(f"unsupported sampling_type: {sampling_type!r}")
    s, h, w = shape
    volume = s * h * w
    offset_count = volume // num_context + 1
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        draws = GeneratorDraws(generator, batch_size, volume, num_context,
                               num_classes, sampling_type)
        device = generator.device
    full = torch.full((batch_size, volume), mask_token, dtype=torch.int64,
                      device=device)
    for i in range(num_iterations):
        # f32, as JAX's traced i / (num_iterations - 1.0)
        frac = np.float32(i) / np.float32(num_iterations - 1)
        alpha = float(np.clip(frac, 0.0, 1.0))
        t = torch.full((batch_size,), float(np.float32(1.0) - frac),
                       dtype=torch.float32, device=device)
        perm, order = draws.iteration(i)
        for k in range(offset_count):
            d = draws.chunk(i, k)
            if sampling_type == "uniform":
                start = (k * num_context) % volume
                indices = torch.roll(perm, -start, dims=1)[:, :num_context]
            else:
                # f32 on the device: no host read of the chunk order
                o = order[k].to(device=device, dtype=torch.float32) / (offset_count - 1)
                indices = sample_time_dependent(
                    batch_size, num_context, shape, t, o=o.expand(batch_size),
                    uniforms=d.positions)
            indices = indices.to(device)
            inp = torch.gather(full, 1, indices)
            inp = torch.where(d.mask.to(device) > alpha, mask_token, inp)
            logits = logits_fn(inp, indices).float()
            draw = (logits + d.gumbel.to(device)).argmax(-1)
            full.scatter_(1, indices, draw)
    return full.reshape(batch_size, s, h, w)
