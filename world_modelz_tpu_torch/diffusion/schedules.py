"""Named diffusion-time noise schedules (port of
``world_modelz_tpu.diffusion.schedules``).

The masked-denoise trainer warps r ~ U[0, 1) through a cosine power to
bias training toward chosen corruption levels (masked_denoise_prototype/
main.py:323-337).
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _cos(r: torch.Tensor) -> torch.Tensor:
    # clamped at 0: in f32, cos at r = 1 is slightly negative, and the
    # fractional power of cos05 would make it NaN (docs/PARITY.md)
    return torch.cos((r + 0.01) / 1.01 * math.pi * 0.5).clamp_min(0.0)


_SCHEDULES: dict = {
    "linear": lambda r: r,
    "cos1": _cos,
    "cos2": lambda r: _cos(r) ** 2,
    "cos05": lambda r: _cos(r) ** 0.5,
    "cos3": lambda r: _cos(r) ** 3,
    "cos2_inv": lambda r: 1.0 - _cos(r) ** 2,
    "cos3_inv": lambda r: 1.0 - _cos(r) ** 3,
}


def named_schedule(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The schedule called ``name``; an unknown name raises ValueError."""
    try:
        return _SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; available: {sorted(_SCHEDULES)}"
        ) from None
