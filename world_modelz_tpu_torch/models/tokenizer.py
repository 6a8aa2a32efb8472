"""VQ-VAE frame tokenizer, inference half: conv encoder -> nearest code ->
conv decoder.

Port of ``world_modelz_tpu.models.tokenizer.VQAutoEncoder.encode`` /
``decode`` (reference: minecraft/train_vqae.py:22-55) in eval mode. Images
are NHWC floats in [0, 1]; token grids are (B, H / 2^L, W / 2^L) int32 in
[0, num_embeddings). On CUDA the nearest-code search runs the hand-written
kernel (``kernels/vq_kernels.py``), the counterpart of the JAX
``vq_backend="pallas"`` encode; on the CPU it runs the plain version.
"""

from __future__ import annotations

import torch
from torch import nn

from world_modelz_tpu_torch._device import DeviceLike, resolve_device
from world_modelz_tpu_torch.kernels.vq_kernels import vq_encode_nearest
from world_modelz_tpu_torch.models.conv import (
    SimpleResidualDecoder,
    SimpleResidualEncoder,
)
from world_modelz_tpu_torch.ops.vq import vq_decode


class VectorQuantizer(nn.Module):
    """Codebook holder with the reference buffer layout: ``embedding``
    (L, K, D) and ``cluster_size`` (L, K) (vq/vq.py:15-16). Inference reads
    ``embedding`` only."""

    def __init__(self, num_latents: int, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.register_buffer(
            "embedding", torch.randn(num_latents, num_embeddings, embedding_dim)
        )
        self.register_buffer(
            "cluster_size", torch.ones(num_latents, num_embeddings)
        )


class VQAutoEncoder(nn.Module):
    """Frozen VQ-VAE tokenizer (eval-mode BatchNorm).

    Args:
      embedding_dim, num_embeddings: codebook width D and size K.
      downscale_steps: L; the token grid is the image grid / 2^L.
      hidden_planes: conv width of the residual blocks.
      in_channels: image channels.
      device: ``None`` means ``"cuda"`` (raises without a GPU); pass
        ``"cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        embedding_dim: int,
        num_embeddings: int,
        downscale_steps: int = 2,
        hidden_planes: int = 128,
        in_channels: int = 3,
        *,
        device: DeviceLike = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.downscale_steps = downscale_steps
        self.in_channels = in_channels
        self.encoder = SimpleResidualEncoder(
            in_channels, embedding_dim, downscale_steps, hidden_planes
        )
        self.decoder = SimpleResidualDecoder(
            embedding_dim, [hidden_planes] * downscale_steps, in_channels
        )
        self.vq = VectorQuantizer(1, num_embeddings, embedding_dim)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.vq.embedding.device

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, h, w) int32 tokens."""
        x = torch.as_tensor(x, device=self.device)
        h = self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        flat = h.reshape(-1, self.embedding_dim).contiguous()
        idx = vq_encode_nearest(flat, self.vq.embedding[0])
        return idx.reshape(h.shape[:-1])

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, h, w) tokens -> (B, H, W, C) images. Out-of-range tokens
        (the mask token K) are clamped into the codebook."""
        tokens = torch.as_tensor(tokens, device=self.device)
        vectors = vq_decode(self.vq.embedding, tokens[..., None]).squeeze(-2)
        out = self.decoder(vectors.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)


@torch.no_grad()
def tokenizer_inference_cast(tok: VQAutoEncoder) -> VQAutoEncoder:
    """Round a frozen tokenizer's conv weights and BatchNorm statistics to
    bfloat16 values, in place; the codebook stays f32.

    This is what ``world_modelz_tpu.models.tokenizer.tokenizer_inference_cast``
    does to a tokenizer fed f32 images: flax promotes f32 inputs with bf16
    parameters to f32, so the convs compute in f32 with bf16-rounded
    weights. The tensors here keep their f32 storage, which gives the same
    numbers. Returns ``tok``.
    """
    for module in (tok.encoder, tok.decoder):
        for t in list(module.parameters()) + list(module.buffers()):
            if t.dtype == torch.float32:
                t.copy_(t.to(torch.bfloat16).to(torch.float32))
    return tok
