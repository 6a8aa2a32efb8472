"""VQ-VAE frame tokenizer: conv encoder -> EMA vector quantizer -> conv
decoder.

Port of ``world_modelz_tpu.models.tokenizer.VQAutoEncoder`` (reference:
minecraft/train_vqae.py:22-55). Images are NHWC floats in [0, 1]; token
grids are (B, H / 2^L, W / 2^L) int32 in [0, num_embeddings). ``encode``
and ``decode`` run the conv stacks in eval mode; ``forward`` is the
training pass (batch-statistics BatchNorm, EMA codebook update). On CUDA
the nearest-code search runs the hand-written kernels
(``kernels/vq_kernels.py``): ``vq_encode_nearest`` for encode and
``vq_train_stats`` (through ``ops.vq.vq_apply_fused``) for training, the
counterparts of the JAX ``vq_backend="pallas"`` paths; on the CPU they run
their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from world_modelz_tpu_torch._device import DeviceLike, resolve_device
from world_modelz_tpu_torch.kernels.vq_kernels import vq_encode_nearest
from world_modelz_tpu_torch.models.conv import (
    SimpleResidualDecoder,
    SimpleResidualEncoder,
)
from world_modelz_tpu_torch.ops.vq import (
    VQOutput,
    VQState,
    vq_apply,
    vq_apply_fused,
    vq_decode,
)


class VectorQuantizer(nn.Module):
    """Holder of the quantizer's state (JAX ``VQState``) in buffers.

    ``embedding`` (L, K, D) and ``cluster_size`` (L, K) are the reference
    buffer layout (vq/vq.py:15-16), so its state_dicts load with
    ``strict=True``. ``activation_count`` and ``accumulated_error`` (L, K),
    the statistics dead-code revival reads, are not part of that layout:
    they are registered with ``persistent=False``, and the tokenizer
    trainer checkpoints them beside the state_dict (``stats()``,
    ``load_stats()``).
    """

    def __init__(self, num_latents: int, num_embeddings: int, embedding_dim: int):
        super().__init__()
        shape = (num_latents, num_embeddings)
        self.register_buffer(
            "embedding", torch.randn(*shape, embedding_dim)
        )
        self.register_buffer("cluster_size", torch.ones(shape))
        self.register_buffer(
            "activation_count", torch.zeros(shape), persistent=False)
        self.register_buffer(
            "accumulated_error", torch.zeros(shape), persistent=False)

    def state(self) -> VQState:
        """The buffers as a ``VQState`` (the same tensors, not copies)."""
        return VQState(self.embedding, self.cluster_size,
                       self.activation_count, self.accumulated_error)

    @torch.no_grad()
    def load_state(self, state: VQState) -> None:
        """Copy ``state`` into the buffers, in place."""
        current = self.state()
        for f in dataclasses.fields(state):
            buf, val = getattr(current, f.name), getattr(state, f.name)
            if val is not buf:
                buf.copy_(val)

    def stats(self) -> dict:
        """The two statistics outside the state_dict, for checkpoints."""
        return {"activation_count": self.activation_count,
                "accumulated_error": self.accumulated_error}

    @torch.no_grad()
    def load_stats(self, stats: dict) -> None:
        self.activation_count.copy_(stats["activation_count"])
        self.accumulated_error.copy_(stats["accumulated_error"])


class VQAutoEncoder(nn.Module):
    """VQ-VAE tokenizer. The module stays in eval mode: ``encode`` and
    ``decode`` use the running BatchNorm statistics, and ``forward`` sets
    the conv stacks' mode for its own call.

    Args:
      embedding_dim, num_embeddings: codebook width D and size K.
      downscale_steps: L; the token grid is the image grid / 2^L.
      hidden_planes: conv width of the residual blocks.
      in_channels: image channels.
      vq_backend: the training quantizer on the CPU, as the JAX option:
        ``"xla"`` runs ``vq_apply``, ``"pallas"`` ``vq_apply_fused`` with
        the plain statistics. On CUDA both run ``vq_apply_fused``, whose
        statistics come from the ``vq_train_stats`` kernel.
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
        vq_backend: str = "xla",
        device: DeviceLike = None,
    ):
        super().__init__()
        if vq_backend not in ("xla", "pallas"):
            raise ValueError(
                f"vq_backend must be 'xla' or 'pallas', got {vq_backend!r}")
        dev = resolve_device(device)
        self.vq_backend = vq_backend
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.downscale_steps = downscale_steps
        self.in_channels = in_channels
        # the constructor's arguments (a serving artifact rebuilds the model)
        self.config = dict(
            embedding_dim=embedding_dim, num_embeddings=num_embeddings,
            downscale_steps=downscale_steps, hidden_planes=hidden_planes,
            in_channels=in_channels)
        self.encoder = SimpleResidualEncoder(
            in_channels, embedding_dim, downscale_steps, hidden_planes
        )
        self.decoder = SimpleResidualDecoder(
            embedding_dim, [hidden_planes] * downscale_steps, in_channels
        )
        self.vq = VectorQuantizer(1, num_embeddings, embedding_dim)
        self.mesh = None  # the data axis of a data-parallel trainer
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.vq.embedding.device

    def token_grid_shape(self, image_hw: Tuple[int, int]) -> Tuple[int, int]:
        """The token grid of an (H, W) image, as the JAX tokenizer's."""
        f = 2 ** self.downscale_steps
        return (image_hw[0] // f, image_hw[1] // f)

    def forward(
        self, x: torch.Tensor, train: bool = True
    ) -> Tuple[torch.Tensor, VQOutput]:
        """The autoencoding pass (JAX ``forward``, train_vqae.py:33-43):
        (B, H, W, C) images -> (reconstruction (B, H, W, C), VQOutput).

        With ``train``, BatchNorm normalizes with batch statistics and
        updates its running statistics, and the codebook takes its EMA
        update from the batch's assignments to the old codebook. The VQ
        activation and error statistics accumulate in both modes. The
        buffers are updated in place."""
        stacks = (self.encoder, self.decoder)
        modes = [m.training for m in stacks]
        for m in stacks:
            m.train(train)
        try:
            h = self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            fused = h.device.type == "cuda" or self.vq_backend == "pallas"
            apply = vq_apply_fused if fused else vq_apply
            # the JAX tokenizer's EMA decay 0.99 and eps 1e-5 (the defaults)
            out, new_vq = apply(self.vq.state(), h, train=train, mesh=self.mesh)
            self.vq.load_state(new_vq)
            recon = self.decoder(out.quantized.permute(0, 3, 1, 2))
        finally:
            for m, mode in zip(stacks, modes):
                m.train(mode)
        return recon.permute(0, 2, 3, 1), out

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, h, w) int32 tokens."""
        h = self.encode_continuous(x)
        flat = h.reshape(-1, self.embedding_dim).contiguous()
        idx = vq_encode_nearest(flat, self.vq.embedding[0])
        return idx.reshape(h.shape[:-1])

    @torch.no_grad()
    def encode_continuous(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> the pre-quantization encoder latents
        (B, h, w, D), as ``encode`` runs the encoder: the learned feature
        space of the FVD harness's ``tokenizer`` extractor."""
        x = torch.as_tensor(x, device=self.device)
        return self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

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
