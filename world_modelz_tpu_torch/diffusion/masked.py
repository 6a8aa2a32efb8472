"""Masked discrete diffusion: the corruption process, iterative unmasking
and rollout.

Port of ``world_modelz_tpu.diffusion.masked``. ``corrupt_tokens`` is the
training corruption (reference: vq-video-diffusion/main.py:246-259):
Bernoulli(r) masking plus a uniform resample with probability
r * p_max_uniform. The sampler (reference: minecraft/main2.py:85-131)
starts from flat logits; each of ``num_iterations`` steps draws a candidate
last frame, re-masks a shrinking ``1 - alpha`` fraction of it and queries
the denoiser; ``rollout_frames`` repeats that per generated frame and
shifts the context window.

Randomness is explicit. ``corrupt_tokens`` takes its three draws (mask
uniforms, resample uniforms, uniform class ids) as tensors. One unmask step
consumes a Gumbel tensor (B, H, W, K) — ``jax.random.categorical`` is
``argmax(logits + gumbel)`` — and a re-mask uniform tensor (B, H, W). By
default they come from a ``torch.Generator``; a caller (the tests) may hand
in its own draws. ``draw_last_frame`` is a step's draw with ``alpha`` a
float or a 0-d tensor: the form a captured step (``aot.py``) replays.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

# (frame, iteration) -> (gumbel (B, H, W, K), uniform (B, H, W)), both f32
Noise = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]
LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def corrupt_tokens(
    tokens: torch.Tensor,
    r: torch.Tensor,
    *,
    num_classes: int,
    mask_token: int,
    p_max_uniform: float = 0.1,
    mask_uniform: Optional[torch.Tensor] = None,
    resample_uniform: Optional[torch.Tensor] = None,
    uniform_classes: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the forward (corruption) process to clean tokens.

    Args:
      tokens: (B, N) int tokens in [0, num_classes).
      r: (B,) diffusion times in [0, 1].
      num_classes: codebook size.
      mask_token: index of masked positions (== num_classes).
      p_max_uniform: max uniform-resample probability (main2.py:221).
      mask_uniform, resample_uniform: (B, N) uniforms in [0, 1); position n
        is masked where ``mask_uniform < r`` and resampled where
        ``resample_uniform < r * p_max_uniform``.
      uniform_classes: (B, N) int class ids in [0, num_classes) for the
        resampled positions.
      generator: source of the draws not given (on the tokens' device).

    Returns:
      (corrupted tokens (B, N), mask (B, N) bool — True where masked).
    """
    b, n = tokens.shape
    dev = tokens.device
    if mask_uniform is None:
        mask_uniform = torch.rand((b, n), generator=generator, device=dev)
    if resample_uniform is None:
        resample_uniform = torch.rand((b, n), generator=generator, device=dev)
    if uniform_classes is None:
        uniform_classes = torch.randint(
            0, num_classes, (b, n), generator=generator, device=dev)
    r = r.reshape(b, 1)
    mask = mask_uniform < r
    resample = resample_uniform < r * p_max_uniform
    corrupted = torch.where(resample, uniform_classes.to(tokens.dtype), tokens)
    corrupted = torch.where(mask, mask_token, corrupted)
    return corrupted, mask


def top_k_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, set the rest to -inf
    (main2.py:40-44)."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def generator_noise(
    generator: torch.Generator, shape: Tuple[int, int, int], num_classes: int
) -> Noise:
    """Draws for every step from ``generator`` (on its device): standard
    Gumbel noise -log(-log(U)) and re-mask uniforms U, U ~ [0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    device = generator.device

    def draw(frame: int, iteration: int):
        u = torch.rand(
            (*shape, num_classes), generator=generator, device=device
        )
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        remask = torch.rand(shape, generator=generator, device=device)
        return gumbel, remask

    return draw


def unmask_alpha(iteration: int, num_iterations: int) -> float:
    """The kept fraction of step ``iteration``: ``(iteration + 1) /
    num_iterations`` as f32 division, clipped to [0, 1], as the JAX loop
    computes it (an f32 value, held in a Python float)."""
    frac = np.float32(iteration + 1) / np.float32(num_iterations)
    return float(min(max(frac, 0.0), 1.0))


def draw_last_frame(
    logits: torch.Tensor,
    gumbel: torch.Tensor,
    uniform: torch.Tensor,
    alpha,
    *,
    mask_token: int,
    sample_topk: int = -1,
) -> torch.Tensor:
    """A step's new last frame: ``argmax(logits + gumbel)`` over the top
    ``sample_topk`` logits (all where <= 0), re-masked where ``uniform >
    alpha``. ``alpha`` is a Python float or a 0-d f32 tensor on the
    logits' device (what a captured step reads from its static buffer):
    either way the comparison is made in f32, so the tokens are the
    same."""
    if sample_topk > 0:
        logits = top_k_logits(logits, sample_topk)
    draw = (logits + gumbel).argmax(-1)
    return torch.where(uniform > alpha, mask_token, draw)


def unmask_step(
    iteration: int,
    batch_z: torch.Tensor,
    logits: torch.Tensor,
    gumbel: torch.Tensor,
    uniform: torch.Tensor,
    *,
    num_iterations: int,
    mask_token: int,
    sample_topk: int = -1,
    topk_from_iteration: int = 1,
) -> torch.Tensor:
    """One unmask step (main2.py:89-124): draw a last frame from ``logits``
    with the given Gumbel noise, re-mask where ``uniform > alpha``, and
    return the new token grid (the model is queried by the caller). Top-k
    filtering applies from iteration ``topk_from_iteration`` on
    (main2.py:97-98; the MovingMNIST variant applies it from iteration 0,
    main.py:83-84)."""
    draw = draw_last_frame(
        logits, gumbel, uniform, unmask_alpha(iteration, num_iterations),
        mask_token=mask_token,
        sample_topk=sample_topk if iteration >= topk_from_iteration else -1,
    )
    batch_z = batch_z.clone()
    batch_z[:, -1] = draw
    return batch_z


def unmask_frame(
    logits_fn: LogitsFn,
    context: torch.Tensor,
    *,
    num_classes: int,
    mask_token: int,
    num_iterations: int = 30,
    sample_topk: int = -1,
    topk_from_iteration: int = 1,
    noise: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
) -> torch.Tensor:
    """Iteratively denoise the (masked) last frame of a token-grid clip.

    Args:
      logits_fn: tokens (B, S, H, W) -> last-frame logits (B, H, W, K).
      context: (B, S, H, W) int tokens; the last frame is overwritten.
      noise: iteration -> (gumbel, uniform) draws of that step.

    Returns:
      (B, H, W) denoised last-frame tokens. The final step has alpha == 1,
      so nothing is re-masked.
    """
    b, _, h, w = context.shape
    logits = torch.zeros(
        (b, h, w, num_classes), dtype=torch.float32, device=context.device
    )
    batch_z = context.long().clone()
    batch_z[:, -1] = mask_token
    for i in range(num_iterations):
        gumbel, uniform = noise(i)
        batch_z = unmask_step(
            i, batch_z, logits, gumbel.reshape(b, h, w, num_classes),
            uniform.reshape(b, h, w),
            num_iterations=num_iterations, mask_token=mask_token,
            sample_topk=sample_topk, topk_from_iteration=topk_from_iteration,
        )
        # f32: the sampling math stays full precision whatever the model's
        # compute dtype
        logits = logits_fn(batch_z).float()
    return batch_z[:, -1]


def rollout_frames(
    logits_fn: LogitsFn,
    context: torch.Tensor,
    *,
    num_frames: int,
    num_classes: int,
    mask_token: int,
    num_iterations: int = 30,
    sample_topk: int = -1,
    topk_from_iteration: int = 1,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Noise] = None,
) -> torch.Tensor:
    """Autoregressive multi-frame rollout (main2.py:85-131).

    Generates ``num_frames`` frames, each by ``unmask_frame``, shifting the
    context by one frame after each: the oldest frame is dropped, the new
    one appended, and the last (generation) slot kept (main2.py:128-129).
    Draws come from ``noise`` when given, else from ``generator`` (a fresh
    generator seeded 0 on the context's device when neither is given).

    Returns:
      (B, num_frames, H, W) generated tokens (int64).
    """
    b, _, h, w = context.shape
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=context.device)
            generator.manual_seed(0)
        noise = generator_noise(generator, (b, h, w), num_classes)
    context = context.long()
    frames = []
    for t in range(num_frames):
        frame = unmask_frame(
            logits_fn, context,
            num_classes=num_classes, mask_token=mask_token,
            num_iterations=num_iterations, sample_topk=sample_topk,
            topk_from_iteration=topk_from_iteration,
            noise=lambda i, t=t: noise(t, i),
        )
        frames.append(frame)
        context = shift_context(context, frame)
    return torch.stack(frames, dim=1)


def shift_context(context: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """The context after generating ``frame`` (B, H, W): the oldest frame
    dropped, ``frame`` appended, the last (generation) slot kept
    (main2.py:128-129)."""
    return torch.cat([context[:, 1:-1], frame[:, None], context[:, -1:]], dim=1)
