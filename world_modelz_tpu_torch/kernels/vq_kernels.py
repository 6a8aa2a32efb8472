"""VQ kernels and their wrappers.

``vq_encode_nearest``: the nearest-code search ``csrc/vq_encode.cu``,
counterpart of ``world_modelz_tpu.kernels.vq_kernels.vq_encode_pallas`` in
its index-only form; plain version ``ops.vq.vq_encode``.

``vq_train_stats``: the fused search + EMA statistics of a tokenizer
training step, ``csrc/vq_train.cu``, counterpart of
``vq_train_stats_pallas``; plain version ``ops.vq.vq_train_stats_reference``.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
Both kernels run the one search of ``csrc/vq_search.cuh``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from world_modelz_tpu_torch.kernels._build import LAUNCHES, check, load_library, stream
from world_modelz_tpu_torch.ops.vq import vq_encode, vq_train_stats_reference

MAX_D = 64  # the kernel stages x and codebook chunks for D <= 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _on_cpu(x: torch.Tensor, codebook: torch.Tensor) -> bool:
    """Check shapes; True when both tensors lie on the CPU (the plain
    version runs), False when they share a CUDA device (the kernel runs);
    anything else raises."""
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(
            f"expected x (N, D) and codebook (K, D), got {tuple(x.shape)} "
            f"and {tuple(codebook.shape)}"
        )
    if x.device.type == "cpu" and codebook.device.type == "cpu":
        return True
    if x.device.type != "cuda" or codebook.device != x.device:
        raise ValueError(
            f"x and codebook must share one CUDA device (or both lie on the "
            f"CPU), got {x.device} and {codebook.device}"
        )
    return False


def _check_kernel_inputs(x: torch.Tensor, codebook: torch.Tensor, dtypes) -> None:
    if x.dtype not in dtypes or codebook.dtype != torch.float32:
        names = "/".join(str(t).replace("torch.", "") for t in dtypes)
        raise TypeError(
            f"vq kernel takes x {names} and a float32 codebook, got "
            f"{x.dtype} and {codebook.dtype}"
        )
    n, d = x.shape
    k = codebook.shape[0]
    if not 0 < d <= MAX_D:
        raise ValueError(f"vq kernel supports 0 < D <= {MAX_D}, got {d}")
    if k == 0:
        raise ValueError("vq kernel needs a codebook of at least one code")
    if not (x.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("vq kernel needs contiguous x and codebook")
    if n >= 2**31 or k * d >= 2**31:
        raise ValueError(f"vq kernel indexes with int32, got N={n}, K={k}")


def _scratch(lib, x: torch.Tensor, k: int, train: bool) -> torch.Tensor:
    """The kernel's device scratch (the codebook's split planes and code
    norms and, for the statistics, per-row errors), sized by the C entry."""
    nbytes = lib.wmz_vq_scratch_bytes(x.shape[0], k, int(train))
    return torch.empty((nbytes,), dtype=torch.uint8, device=x.device)


def vq_encode_nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices for flat inputs (D <= 64 on CUDA).

    Args:
      x: (N, D) float32 or bfloat16 rows.
      codebook: (K, D) float32 code vectors (single latent).

    Returns:
      (N,) int32 indices of ``argmin_k |x - e_k|^2``; ties go to the lowest k.
    """
    if _on_cpu(x, codebook):
        return vq_encode(codebook[None], x[:, None, :]).reshape(-1)
    _check_kernel_inputs(x, codebook, _DTYPES)
    n, d = x.shape
    k = codebook.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return idx
    lib = load_library()
    scratch = _scratch(lib, x, k, train=False)
    LAUNCHES["vq_encode"] += 1
    status = lib.wmz_vq_encode(
        x.data_ptr(), codebook.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
        n, k, d, _DTYPES[x.dtype], stream(x),
    )
    check(status, "vq_encode")
    return idx


def vq_train_stats(
    x: torch.Tensor, codebook: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused nearest-code search + EMA statistics of one training step.

    Args:
      x: (N, D) float32 rows (D <= 64 on CUDA).
      codebook: (K, D) float32 code vectors (single latent).

    Returns:
      idx (N,) int32 (ties to the lowest k; the codes ``vq_encode_nearest``
      picks), q (N, D) f32 (the old codebook's codes, gathered exactly),
      cnt (K,) f32 (exact counts), err (K,) f32 (per-code sums of
      max(min dist + |x|^2, 0)) and dw (K, D) f32 (per-code sums of x).
      On CUDA, two calls on the same input give bitwise-equal results.
    """
    if _on_cpu(x, codebook):
        return vq_train_stats_reference(x, codebook)
    _check_kernel_inputs(x, codebook, (torch.float32,))
    n, d = x.shape
    k = codebook.shape[0]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    q = torch.empty((n, d), **f32)
    if n == 0:
        return idx, q, torch.zeros((k,), **f32), torch.zeros((k,), **f32), \
            torch.zeros((k, d), **f32)
    cnt, err = torch.empty((k,), **f32), torch.empty((k,), **f32)
    dw = torch.empty((k, d), **f32)
    lib = load_library()
    scratch = _scratch(lib, x, k, train=True)
    LAUNCHES["vq_train_stats"] += 1
    status = lib.wmz_vq_train_stats(
        x.data_ptr(), codebook.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
        q.data_ptr(), cnt.data_ptr(), err.data_ptr(), dw.data_ptr(), n, k, d,
        stream(x),
    )
    check(status, "vq_train_stats")
    return idx, q, cnt, err, dw
