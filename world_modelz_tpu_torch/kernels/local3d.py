"""Local-3D attention forward: the CUDA kernel ``csrc/local3d_fwd.cu`` and
its wrapper.

Counterpart of ``world_modelz_tpu.kernels.local3d.local3d_attention_pallas``
(forward). A CUDA tensor launches the kernel; a CPU tensor takes the plain
version, ``models.attention.local3d_attention``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from world_modelz_tpu_torch.kernels._build import LAUNCHES, check, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def local3d_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    extents: Tuple[int, int, int],
    heads: int,
) -> torch.Tensor:
    """Windowed space-time attention; same contract as the plain version.

    Args:
      q, k, v: (B, S, H, W, heads * dim_head), float32 or bfloat16.
      extents: (e_s, e_h, e_w) half-widths of the window.
      heads: number of heads.

    Returns:
      (B, S, H, W, heads * dim_head) in the input dtype.
    """
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"expected q, k, v of one (B, S, H, W, inner) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, w, inner = q.shape
    if inner % heads:
        raise ValueError(f"inner width {inner} not divisible by heads={heads}")
    devices = {t.device for t in (q, k, v)}
    if devices == {torch.device("cpu")}:
        from world_modelz_tpu_torch.models.attention import local3d_attention

        return local3d_attention(q, k, v, extents, heads)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(
            f"q, k, v must share one CUDA device (or all lie on the CPU), "
            f"got {sorted(map(str, devices))}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"local3d kernel takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    dh = inner // heads
    if dh % 32 or dh > 256:
        raise ValueError(
            f"local3d kernel needs dim_head % 32 == 0 and <= 256, got {dh}"
        )
    es, eh, ew = (int(e) for e in extents)
    if min(es, eh, ew) < 0:
        raise ValueError(f"extents must be >= 0, got {extents}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("local3d kernel needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("local3d kernel needs 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = load_library()
    LAUNCHES["local3d_fwd"] += 1
    status = lib.wmz_local3d_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, w, heads, dh, es, eh, ew, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(status, "local3d_fwd")
    return out
