"""Nearest-code search: the CUDA kernel ``csrc/vq_encode.cu`` and its wrapper.

Counterpart of ``world_modelz_tpu.kernels.vq_kernels.vq_encode_pallas`` in
its index-only form. A CUDA tensor launches the kernel; a CPU tensor takes
the plain version, ``ops.vq.vq_encode``.
"""

from __future__ import annotations

import torch

from world_modelz_tpu_torch.kernels._build import LAUNCHES, check, load_library
from world_modelz_tpu_torch.ops.vq import vq_encode

MAX_D = 64  # the kernel stages x and codebook chunks for D <= 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def vq_encode_nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices for flat inputs (D <= 64 on CUDA).

    Args:
      x: (N, D) float32 or bfloat16 rows.
      codebook: (K, D) float32 code vectors (single latent).

    Returns:
      (N,) int32 indices of ``argmin_k |x - e_k|^2``; ties go to the lowest k.
    """
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(
            f"expected x (N, D) and codebook (K, D), got {tuple(x.shape)} "
            f"and {tuple(codebook.shape)}"
        )
    if x.device.type == "cpu" and codebook.device.type == "cpu":
        return vq_encode(codebook[None], x[:, None, :]).reshape(-1)
    if x.device.type != "cuda" or codebook.device != x.device:
        raise ValueError(
            f"x and codebook must share one CUDA device (or both lie on the "
            f"CPU), got {x.device} and {codebook.device}"
        )
    if x.dtype not in _DTYPES or codebook.dtype != torch.float32:
        raise TypeError(
            f"vq kernel takes x float32/bfloat16 and a float32 codebook, got "
            f"{x.dtype} and {codebook.dtype}"
        )
    n, d = x.shape
    k = codebook.shape[0]
    if not 0 < d <= MAX_D:
        raise ValueError(f"vq kernel supports 0 < D <= {MAX_D}, got {d}")
    if not (x.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("vq kernel needs contiguous x and codebook")
    if n >= 2**31 or k >= 2**31:
        raise ValueError(f"vq kernel indexes rows with int32, got N={n}")
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return idx
    # scratch: the transposed codebook and the code norms
    e_t = torch.empty((d, k), dtype=torch.float32, device=x.device)
    e_sq = torch.empty((k,), dtype=torch.float32, device=x.device)
    lib = load_library()
    LAUNCHES["vq_encode"] += 1
    status = lib.wmz_vq_encode(
        x.data_ptr(), codebook.data_ptr(), e_t.data_ptr(), e_sq.data_ptr(),
        idx.data_ptr(), n, k, d, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(status, "vq_encode")
    return idx
