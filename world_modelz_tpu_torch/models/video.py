"""Next-frame masked-diffusion denoiser.

Port of ``world_modelz_tpu.models.video.VqVideoDiffusionModel``
(reference: minecraft/main2.py:26-37): a local-3D-attention transformer over
(n_past + 1)-frame token grids with one extra embedding row for the mask
class; logits are predicted for the last frame only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from world_modelz_tpu_torch._device import DeviceLike, resolve_device
from world_modelz_tpu_torch.models.attention import Local3dAttentionTransformer


class VqVideoDiffusionModel(nn.Module):
    """Input (B, S, H, W) int tokens in [0, num_classes] (num_classes is the
    mask token); output (B, H, W, num_classes) last-frame logits in the
    parameters' dtype.

    ``device=None`` means ``"cuda"`` (raises without a GPU); ``dtype`` is the
    parameter dtype (the serving configuration runs bfloat16). The model
    starts in eval mode, as serving uses it; a trainer calls ``.train()``
    (dropout on, flax's ``train=True``).
    """

    def __init__(
        self,
        data_shape: Tuple[int, int, int],
        dim: int,
        num_classes: int,
        extents: Tuple[int, int, int],
        depth: int,
        dim_head: int,
        mlp_dim: int,
        heads: int = 1,
        dropout: float = 0.0,
        *,
        device: DeviceLike = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.transformer = Local3dAttentionTransformer(
            data_shape=data_shape,
            dim=dim,
            num_classes=num_classes + 1,  # + mask class (main2.py:30)
            extents=extents,
            depth=depth,
            heads=heads,
            dim_head=dim_head,
            mlp_dim=mlp_dim,
            dropout=dropout,
        )
        self.logit_proj = nn.Linear(dim, num_classes)
        self.to(device=dev, dtype=dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.logit_proj.weight.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.transformer(tokens)
        return self.logit_proj(x[:, -1])  # (B, H, W, num_classes)
