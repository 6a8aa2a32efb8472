"""Vector-quantization ops (plain PyTorch)."""

from world_modelz_tpu_torch.ops.vq import (
    codebook_distances,
    vq_decode,
    vq_encode,
)

__all__ = [
    "codebook_distances",
    "vq_encode",
    "vq_decode",
]
