"""Masked discrete diffusion: corruption and sampling, and the sparse
space-time position samplers and volume sweep; the continuous Gaussian DDPM
of the SOM-DDPM pipeline (``diffusion.ddpm``)."""

from world_modelz_tpu_torch.diffusion.ddpm import alpha_bar, ddpm_corrupt, ddpm_sample
from world_modelz_tpu_torch.diffusion.masked import (
    corrupt_tokens,
    generator_noise,
    rollout_frames,
    top_k_logits,
    unmask_frame,
    unmask_step,
)
from world_modelz_tpu_torch.diffusion.sparse import (
    GeneratorDraws,
    sample_flat_positions,
    sample_time_dependent,
    sparse_denoise_volume,
)

__all__ = [
    "corrupt_tokens",
    "top_k_logits",
    "unmask_step",
    "unmask_frame",
    "rollout_frames",
    "generator_noise",
    "sample_flat_positions",
    "sample_time_dependent",
    "sparse_denoise_volume",
    "GeneratorDraws",
    "alpha_bar",
    "ddpm_corrupt",
    "ddpm_sample",
]
