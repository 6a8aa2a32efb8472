"""Masked discrete diffusion: corruption and sampling."""

from world_modelz_tpu_torch.diffusion.masked import (
    corrupt_tokens,
    generator_noise,
    rollout_frames,
    top_k_logits,
    unmask_frame,
    unmask_step,
)

__all__ = [
    "corrupt_tokens",
    "top_k_logits",
    "unmask_step",
    "unmask_frame",
    "rollout_frames",
    "generator_noise",
]
