"""On-device MovingMNIST compositing: ship trajectories, not pixels.

Port of ``world_modelz_tpu.data.device_composite``. The host generator
(``data/moving_mnist.py``) composites digit sprites into (S, H, W, 1) pixel
clips on the CPU; ``sample_batch_traj`` ships each clip's sprites and
per-frame positions instead (at the m3 width 79,872 bytes a batch of 64
against 1,572,864 of uint8 pixels), and ``composite_clips`` renders the
frames on the device, inside the trainer's step (and so inside its CUDA
graph on the card).

The semantics are the host compositor's (``data/_native/compositor.cpp``
``composite_sprite`` + ``clamp01``): the sprites are added into a zero
canvas at each frame's top-left (y, x), off-canvas parts clipped, and the
frame clamped to [0, 1]. A uint8 sprite contributes its integer value over
255 in f32; float sprites are exact f32; the digits are summed in order.

The JAX module places the sprites with one-hot matmuls, to ride the TPU's
matrix unit. Here each output pixel of each digit gathers
``sprite[y - py, x - px]`` from the sprite padded with a zero row and
column, an index outside the sprite sent to the zeros (``torch.where`` on
the small per-row and per-column index tensors): one indexing launch, no
product, no data-dependent shape and no host read, so it captures into a
CUDA graph.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def composite_clips(sprites: torch.Tensor, pos: torch.Tensor, image_size: int) -> torch.Tensor:
    """Render bouncing-sprite clips on the sprites' device.

    Args:
      sprites: (B, D, K, K) uint8 (1/255-quantized) or float digit sprites.
      pos: (B, D, S, 2) int32 per-frame top-left (y, x) sprite positions.
      image_size: the output canvas side H = W.

    Returns:
      (B, S, H, W, 1) float32 frames in [0, 1]: each frame the additive
      composite of the D sprites, clamped.
    """
    b, d, k = sprites.shape[0], sprites.shape[1], sprites.shape[-1]
    dev = sprites.device
    # each uint8 digit's value over 255 in f32, before the (larger) gather
    sprites = sprites / 255.0 if sprites.dtype == torch.uint8 else sprites.to(torch.float32)
    # a zero row and column at index k: an index outside the sprite reads 0
    padded = torch.nn.functional.pad(sprites, (0, 1, 0, 1))
    r = torch.arange(image_size, device=dev)
    iy = r - pos[..., 0, None].long()  # (B, D, S, H): the sprite row
    ix = r - pos[..., 1, None].long()  # (B, D, S, W): the sprite column
    iy = torch.where((iy >= 0) & (iy < k), iy, k)
    ix = torch.where((ix >= 0) & (ix < k), ix, k)
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1, 1)
    di = torch.arange(d, device=dev).view(1, d, 1, 1, 1)
    vals = padded[bi, di, iy[..., :, None], ix[..., None, :]]  # (B, D, S, H, W) f32
    frames = vals[:, 0]
    for j in range(1, d):
        frames = frames + vals[:, j]
    return frames.clamp(0.0, 1.0)[..., None]


def as_frames(batch: Any, image_size: int) -> torch.Tensor:
    """Any trainer batch -> (B, S, H, W, C) float32 in [0, 1], on the
    batch's device: a trajectory dict {'sprites', 'pos'} is composited, a
    uint8 pixel batch normalized, float pixels passed through, and a dict
    {'frames': pixels} (the step program's static inputs) taken as its
    pixels. Every consumer (the train step, the evaluation rollout, the
    token-grid probe) goes through it."""
    if isinstance(batch, dict) and "frames" in batch:
        batch = batch["frames"]
    if isinstance(batch, dict):
        return composite_clips(torch.as_tensor(batch["sprites"]),
                               torch.as_tensor(batch["pos"]), image_size)
    frames = torch.as_tensor(np.asarray(batch) if not isinstance(batch, torch.Tensor)
                             else batch)
    if frames.dtype == torch.uint8:
        return frames.to(torch.float32) / 255.0
    return frames
