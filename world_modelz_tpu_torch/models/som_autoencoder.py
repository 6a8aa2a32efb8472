"""SOM-quantized convolutional autoencoder.

Port of ``world_modelz_tpu.models.som_autoencoder`` (reference:
``SomAutoEncoder``, som-diffusion/autoencoder.py:156-193 and the finetune
variant at finetune_ae.py:22-49): the tokenizer's conv encoder and decoder
(``models.conv``, the counterpart of JAX's ``_AEModule``) with a 2-D
self-organizing map (``ops.som``) in the bottleneck. ``encode_2d`` and
``decode_2d`` map images to and from (B, h, w, 2) latents in [-1, 1]^2,
the continuous representation the SOM-DDPM is trained on. Images are NHWC
floats at the public methods, as JAX's.

The module stays in eval mode; ``forward(x, train=True)`` and
``encode_latent(x, train=True)`` normalize with batch statistics and
update BatchNorm's running statistics in place (flax's momentum 0.9,
``models.conv.BatchNorm2d``). The SOM is a ``SomState`` beside the
parameters (not in the state_dict): ``tokenizer_state()`` gives both,
``SomTokenizerState``, as a checkpoint keeps them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from world_modelz_tpu_torch._device import DeviceLike, resolve_device
from world_modelz_tpu_torch.models.conv import SimpleResidualDecoder, SimpleResidualEncoder
from world_modelz_tpu_torch.ops.som import (
    SomState,
    som_decode_2d,
    som_encode_2d,
    som_forward,
    som_init,
)


@dataclasses.dataclass
class SomTokenizerState:
    """A SOM autoencoder's state: the conv stacks' state_dict (parameters
    and BatchNorm statistics) and the SOM."""

    state_dict: Dict[str, torch.Tensor]
    som: SomState


class SomAutoEncoder(nn.Module):
    """Conv autoencoder with a SOM bottleneck (JAX's ``SomAutoEncoder``).

    ``pass_through_som``: ``forward`` quantizes the latents through the SOM
    (straight-through) before decoding. ``generator`` draws the SOM's
    uniform init; ``device=None`` means ``"cuda"``."""

    def __init__(
        self,
        embedding_dim: int,
        downscale_steps: int = 2,
        hidden_planes: int = 128,
        in_channels: int = 3,
        som_width: int = 128,
        som_height: int = 128,
        pass_through_som: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.embedding_dim = embedding_dim
        self.downscale_steps = downscale_steps
        self.hidden_planes = hidden_planes
        self.in_channels = in_channels
        self.pass_through_som = pass_through_som
        self.encoder = SimpleResidualEncoder(
            in_channels, embedding_dim, downscale_steps, hidden_planes)
        self.decoder = SimpleResidualDecoder(
            embedding_dim, [hidden_planes] * downscale_steps, in_channels)
        self.to(dev)
        self.som = som_init(som_width, som_height, embedding_dim, generator=generator,
                            device=dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.encoder._conv_1.weight.device

    @property
    def som_width(self) -> int:
        return self.som.width

    @property
    def som_height(self) -> int:
        return self.som.height

    def resize_som(self, width: int, height: int,
                   generator: Optional[torch.Generator] = None) -> None:
        """A fresh SOM of the new size; the conv weights stay
        (train_som.py:168-173)."""
        self.som = som_init(width, height, self.embedding_dim, generator=generator,
                            device=self.device)

    def tokenizer_state(self) -> SomTokenizerState:
        return SomTokenizerState(self.state_dict(), self.som)

    @torch.no_grad()
    def load_tokenizer_state(self, state: SomTokenizerState) -> None:
        self.load_state_dict(state.state_dict, strict=True)
        self.som = SomState(
            embedding=state.som.embedding.to(self.device, torch.float32).clone(),
            activation_count=state.som.activation_count.to(self.device, torch.int32).clone(),
            width=int(state.som.width), height=int(state.som.height))

    def _run(self, module: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
        """``module`` on NHWC ``x`` in the given mode, NHWC out."""
        mode = module.training
        module.train(train)
        try:
            return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        finally:
            module.train(mode)

    def encode_latent(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, C) images -> the conv latents before the SOM
        (B, h, w, D), which ``som_adapt`` fits (train_som.py:82-97)."""
        return self._run(self.encoder, torch.as_tensor(x, device=self.device), train)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """The finetune forward (finetune_ae.py:34-49): (reconstruction,
        the latents before the SOM, the SOM's mean squared difference or
        None when the SOM is bypassed)."""
        h_in = self.encode_latent(x, train)
        h, h_diff = h_in, None
        if self.pass_through_som:
            h, h_diff = som_forward(self.som, h_in)
        return self._run(self.decoder, h, train), h_in, h_diff

    @torch.no_grad()
    def encode_2d(self, x: torch.Tensor) -> torch.Tensor:
        """Images -> (B, h, w, 2) normalized SOM coordinates
        (autoencoder.py:168-171, channels last)."""
        return som_encode_2d(self.som, self.encode_latent(x))

    @torch.no_grad()
    def decode_2d(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 2) coordinates -> images (autoencoder.py:173-176)."""
        h = som_decode_2d(self.som, torch.as_tensor(pos, device=self.device))
        return self._run(self.decoder, h, False)
