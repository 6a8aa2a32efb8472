"""Vector-quantizer lookups (inference half of ``world_modelz_tpu.ops.vq``).

The codebook is a plain ``(L, K, D)`` tensor (L latents, K codes of width
D), the layout of the JAX ``VQState.codebook`` and of the reference
``vq.embedding`` buffer. ``vq_encode`` is the plain version of the CUDA
nearest-code kernel (``kernels/vq_kernels.py``): the CPU path and the tests
use it, the CUDA path never does.
"""

from __future__ import annotations

import torch


def codebook_distances(codebook: torch.Tensor, flat_x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (N, L, K) in f32 via |x|^2 + |e|^2 - 2 x.e.

    flat_x: (N, L, D); codebook: (L, K, D).
    """
    x = flat_x.float()
    e = codebook.float()
    x_sq = (x * x).sum(-1, keepdim=True)  # (N, L, 1)
    e_sq = (e * e).sum(-1)  # (L, K)
    cross = torch.einsum("nld,lkd->nlk", x, e)
    return x_sq + e_sq[None] - 2.0 * cross


def vq_encode(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices (int32), shape ``x.shape[:-1]``.

    The last dimension of ``x`` is the embedding width D; the one before it
    is read (through the flatten) as the latent index, as in the JAX
    ``vq_encode``. Ties go to the lowest code index (``argmin``).
    """
    num_latents, _, dim = codebook.shape
    flat_x = x.reshape(-1, num_latents, dim)
    distances = codebook_distances(codebook, flat_x)
    return distances.argmin(-1).to(torch.int32).reshape(x.shape[:-1])


def vq_decode(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Codebook lookup; output gains a trailing D axis.

    ``indices`` has any leading shape whose flattened trailing layout is
    (N, L). Indices are read as JAX's ``take_along_axis(mode="clip")``
    reads them: a negative index counts from the end, then out-of-range
    indices are clamped into [0, K). The mask token K reaches decode and
    must stay finite.
    """
    num_latents, num_codes, dim = codebook.shape
    flat = indices.reshape(-1, num_latents).long()
    flat = torch.where(flat < 0, flat + num_codes, flat).clamp(0, num_codes - 1)
    latent = torch.arange(num_latents, device=codebook.device)
    quantized = codebook[latent[None, :], flat]  # (N, L, D)
    return quantized.reshape(*indices.shape, dim)
