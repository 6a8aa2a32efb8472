"""Block diffusion (BD3-LM, Arriola et al., arXiv:2503.09573, section 3.2),
as SDAR trains with it.

A sequence x_0 of L tokens is cut into blocks of ``block`` tokens. Each
block draws a mask rate t ~ U(0, 1] (the linear schedule), and each of its
tokens becomes the mask id with probability t: x_t. The model sees [x_t ;
x_0], 2 L positions, under the mask of ``kernels.dense_attention.
bd_allowed`` (a noisy block sees itself and the clean blocks before it, a
clean block the clean blocks up to itself). The loss is the
cross-entropy at the masked positions of x_t, weighted 1 / t and summed,
over the batch's token count B L.

Every random number comes in through the draws (``block_uniform`` (B, L /
block), ``token_uniform`` (B, L)), so the program and a reference that are
handed the same draws corrupt alike.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def mask_rates(block_uniform: torch.Tensor, block: int) -> torch.Tensor:
    """t = 1 - u in (0, 1] for each block, repeated over its tokens:
    (B, L / block) uniforms in [0, 1) -> (B, L)."""
    return (1.0 - block_uniform).repeat_interleave(block, dim=1)


def corrupt(x0: torch.Tensor, block_uniform: torch.Tensor, token_uniform: torch.Tensor,
            block: int, mask_id: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x_t, the masked positions (B, L) bool, t (B, L) f32): each token of
    x_0 (B, L) masked where its uniform falls under its block's rate."""
    t = mask_rates(block_uniform, block)
    masked = token_uniform < t
    return torch.where(masked, torch.full_like(x0, mask_id), x0), masked, t


def layout(xt: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """[x_t ; x_0]: (B, 2 L) tokens."""
    return torch.cat([xt, x0], dim=1)


def loss(logits: torch.Tensor, x0: torch.Tensor, masked: torch.Tensor, t: torch.Tensor
         ) -> torch.Tensor:
    """The 1 / t weighted cross-entropy at the masked positions of the noisy
    half's logits (B, L, V), summed, over B L; f32."""
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), x0.reshape(-1),
                         reduction="none").reshape(x0.shape)
    return torch.where(masked, ce / t, 0.0).sum() / x0.numel()
