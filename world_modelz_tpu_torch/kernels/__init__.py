"""Hand-written CUDA kernels for Hopper, their wrappers and launch counts.

Each wrapper launches its kernel for a CUDA tensor, takes its plain PyTorch
version for a CPU tensor, and counts its launches in ``LAUNCHES``.
``local3d_attention`` and ``flash_attention`` are the differentiable
attentions: each forward kernel with its split backward pair as its
gradient. ``local3d_block`` is the whole attention block in one kernel
(projections, windowed attention, output projection), differentiated
through the unfused composition. The module ``dense_tf32`` holds the f32
dense layers in split TF32 with their epilogues (bias, GELU, residual),
where ``ops.dense.tf32_route`` sends forward passes without autograd.
"""

from world_modelz_tpu_torch.kernels._build import LAUNCHES, load_library
from world_modelz_tpu_torch.kernels.dense_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from world_modelz_tpu_torch.kernels.local3d import (
    local3d_attention,
    local3d_attention_fwd,
    local3d_bwd_dkv,
    local3d_bwd_dq,
)
from world_modelz_tpu_torch.kernels.local3d_block import (
    block_supported,
    local3d_block,
    local3d_block_fwd,
    local3d_block_reference,
)
from world_modelz_tpu_torch.kernels.vq_kernels import (
    vq_encode_nearest,
    vq_train_stats,
)

__all__ = [
    "LAUNCHES",
    "load_library",
    "block_supported",
    "local3d_block",
    "local3d_block_fwd",
    "local3d_block_reference",
    "flash_attention",
    "flash_attention_fwd",
    "flash_bwd_dq",
    "flash_bwd_dkv",
    "local3d_attention",
    "local3d_attention_fwd",
    "local3d_bwd_dq",
    "local3d_bwd_dkv",
    "vq_encode_nearest",
    "vq_train_stats",
]
