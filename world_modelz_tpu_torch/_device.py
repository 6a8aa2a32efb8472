"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a GPU raises.

    The port never drops to the CPU on its own: a caller that wants the CPU
    asks for it with ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (the default) but no GPU is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def platform_device(platform: str) -> torch.device:
    """A trainer's ``--platform``: ``""`` is the GPU (raises without one),
    ``"cpu"`` the CPU."""
    if platform == "":
        return resolve_device(None)
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform must be '' (the GPU) or 'cpu', got {platform!r}")
