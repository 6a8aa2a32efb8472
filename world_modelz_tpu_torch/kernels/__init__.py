"""Hand-written CUDA kernels for Hopper, their wrappers and launch counts.

Each wrapper launches its kernel for a CUDA tensor, takes its plain PyTorch
version for a CPU tensor, and counts its launches in ``LAUNCHES``.
``local3d_attention`` is the differentiable attention: the forward kernel
with the split backward pair as its gradient.
"""

from world_modelz_tpu_torch.kernels._build import LAUNCHES, load_library
from world_modelz_tpu_torch.kernels.local3d import (
    local3d_attention,
    local3d_attention_fwd,
    local3d_bwd_dkv,
    local3d_bwd_dq,
)
from world_modelz_tpu_torch.kernels.vq_kernels import (
    vq_encode_nearest,
    vq_train_stats,
)

__all__ = [
    "LAUNCHES",
    "load_library",
    "local3d_attention",
    "local3d_attention_fwd",
    "local3d_bwd_dq",
    "local3d_bwd_dkv",
    "vq_encode_nearest",
    "vq_train_stats",
]
