"""Denoiser heads for masked discrete video diffusion.

Port of ``world_modelz_tpu.models.video``:
- ``VqVideoDiffusionModel`` (reference: minecraft/main2.py:26-37): a
  local-3D-attention transformer over (n_past + 1)-frame token grids with
  one extra embedding row for the mask class; logits are predicted for the
  last frame only.
- ``VqSparseDiffusionModel`` (reference: minecraft/sparse_diffusion.py:
  75-111): a dense transformer over an arbitrary subset of space-time token
  positions, located by factorized 3D position embeddings decoded from flat
  indices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from world_modelz_tpu_torch._device import DeviceLike, resolve_device
from world_modelz_tpu_torch.models.attention import (
    Dense,
    DenseTransformer,
    Embedding,
    Local3dAttentionTransformer,
)


class VqVideoDiffusionModel(nn.Module):
    """Input (B, S, H, W) int tokens in [0, num_classes] (num_classes is the
    mask token); output (B, H, W, num_classes) last-frame logits in the
    parameters' dtype.

    ``device=None`` means ``"cuda"`` (raises without a GPU); ``dtype`` is the
    parameter dtype (the serving configuration runs bfloat16); ``backend``
    is the attention's (``Local3dAttention``: ``"auto"``, ``"pallas"``,
    ``"xla"`` or ``"fused"``, the whole block in one kernel);
    ``use_checkpointing`` recomputes the plain attention core in the
    backward pass (``Local3dAttention``; JAX's default, True). The model
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
        backend: str = "auto",
        use_checkpointing: bool = True,
        *,
        device: DeviceLike = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        # the constructor's arguments (a serving artifact rebuilds the model)
        self.config = dict(
            data_shape=tuple(int(x) for x in data_shape), dim=dim,
            num_classes=num_classes, extents=tuple(int(e) for e in extents),
            depth=depth, dim_head=dim_head, mlp_dim=mlp_dim, heads=heads,
            dropout=dropout, backend=backend, use_checkpointing=use_checkpointing)
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
            backend=backend,
            use_checkpointing=use_checkpointing,
        )
        self.logit_proj = Dense(dim, num_classes)
        self.to(device=dev, dtype=dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.logit_proj.weight.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.transformer(tokens)
        return self.logit_proj(x[:, -1])  # (B, H, W, num_classes)


class VqSparseDiffusionModel(nn.Module):
    """Sparse space-time denoiser.

    Input: tokens (B, N) int in [0, num_classes] (num_classes is the mask
    token) and their flat positions (B, N) into the S * H * W volume.
    Output: (B, N, num_classes) logits in the parameters' dtype.

    ``device=None`` means ``"cuda"`` (raises without a GPU). The model
    starts in eval mode; a trainer calls ``.train()``. Parameter names are
    the reference state_dict's (``utils/torch_import.py:
    sparse_params_from_torch`` of the JAX package reads them), so
    ``convert.sparse_state_dict_from_params`` loads with ``strict=True``.
    ``moe_experts`` > 0 makes every FFN a mixture of experts
    (``models.attention.MoEFeedForward``, ``moe_capacity_factor``,
    ``moe_impl``); ``forward(..., return_aux=True)`` then returns
    (logits, the layers' mean load-balance loss).
    """

    def __init__(
        self,
        shape: Tuple[int, int, int],
        dim: int,
        num_classes: int,
        depth: int,
        dim_head: int,
        mlp_dim: int,
        heads: int = 1,
        dropout: float = 0.0,
        attn_backend: str = "auto",
        moe_experts: int = 0,
        moe_capacity_factor: float = 1.25,
        moe_impl: str = "dispatch",
        *,
        device: DeviceLike = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.shape = tuple(int(x) for x in shape)
        self.num_classes = num_classes
        s, h, w = self.shape
        self.pos_emb_s = Embedding(s, dim)
        self.pos_emb_h = Embedding(h, dim)
        self.pos_emb_w = Embedding(w, dim)
        self.embedding = Embedding(num_classes + 1, dim)  # + mask class
        self.transformer = DenseTransformer(
            dim, depth, heads=heads, dim_head=dim_head, mlp_dim=mlp_dim,
            dropout=dropout, attn_backend=attn_backend, moe_experts=moe_experts,
            moe_capacity_factor=moe_capacity_factor, moe_impl=moe_impl,
        )
        self.logit_proj = Dense(dim, num_classes)
        self.to(device=dev, dtype=dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.logit_proj.weight.device

    def pos_embedding_3d(self, indices: torch.Tensor) -> torch.Tensor:
        """Flat volume indices -> the sum of their s, h, w embeddings
        (sparse_diffusion.py:100-105)."""
        _, h, w = self.shape
        return (self.pos_emb_s(indices // (h * w))
                + self.pos_emb_h((indices // w) % h)
                + self.pos_emb_w(indices % w))

    def forward(self, tokens: torch.Tensor, indices: torch.Tensor,
                return_aux: bool = False):
        x = self.embedding(tokens.long()) + self.pos_embedding_3d(indices.long())
        if return_aux:
            x, aux = self.transformer(x, return_aux=True)
            return self.logit_proj(x), aux
        return self.logit_proj(self.transformer(x))
