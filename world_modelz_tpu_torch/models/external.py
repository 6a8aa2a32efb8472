"""External tokenizers for the diffusion trainers.

Port of ``world_modelz_tpu.models.external`` (reference:
minecraft/sparse_diffusion_sber.py:23-60, 162-164, 452-453, which swaps the
in-repo VQ-VAE for a pretrained taming-transformers ``GumbelVQ`` VQGAN:
encode through ``model.encode(x)[2][2]``, decode through
``quantize.get_codebook_entry`` and the decoder, with [-1, 1] <-> [0, 1]
range adapters).

Any object with the ``FrameTokenizer`` members drives the sparse trainer:
``num_embeddings``, ``in_channels``, ``encode(images)`` and
``decode(tokens)``, on float [0, 1] NHWC images at both ends. Where the
JAX package's tokenizers take and give numpy arrays on the host, the
port's take tensors (or arrays) and give tensors on the tokenizer's
device: ``NativeTokenizer`` over the port's ``VQAutoEncoder`` (whose
encode runs the ``vq_encode`` kernel on the GPU) and
``TamingGumbelVQAdapter``, whose torch codec runs on the port's device
(the JAX adapter runs it on the host CPU); ``device="cpu"`` asks for the
CPU.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from world_modelz_tpu_torch._device import DeviceLike, resolve_device


@runtime_checkable
class FrameTokenizer(Protocol):
    """The tokenizer contract of the diffusion trainers."""

    num_embeddings: int
    in_channels: int

    def encode(self, images) -> torch.Tensor:
        """(B, H, W, C) float [0, 1] -> (B, h, w) integer token grid."""
        ...

    def decode(self, tokens) -> torch.Tensor:
        """(B, h, w) integer tokens -> (B, H, W, C) float [0, 1]."""
        ...


class NativeTokenizer:
    """The port's ``VQAutoEncoder`` (a trained or imported checkpoint) as a
    ``FrameTokenizer``."""

    def __init__(self, tok):
        self.tok = tok
        self.num_embeddings = tok.num_embeddings
        self.in_channels = tok.in_channels

    @property
    def device(self) -> torch.device:
        return self.tok.device

    def encode(self, images) -> torch.Tensor:
        return self.tok.encode(torch.as_tensor(images, device=self.device))

    def decode(self, tokens) -> torch.Tensor:
        return self.tok.decode(torch.as_tensor(tokens, device=self.device))


class TamingGumbelVQAdapter:
    """A taming-transformers GumbelVQ VQGAN as a ``FrameTokenizer``
    (sparse_diffusion_sber.py:23-49): a yaml config and a checkpoint
    (``{"state_dict": ...}``, loaded with ``strict=False``, as the JAX
    adapter loads it). The config is read with omegaconf when it is
    installed, else with the minimal yaml loader; the model is taming's
    ``GumbelVQ`` when the package is installed, else the port's minimal
    implementation (``models/_gumbelvq_minimal.py``, ``vendored`` True).
    ``device=None`` means ``"cuda"``."""

    def __init__(self, config_path: str, ckpt_path: str, device: DeviceLike = None):
        try:
            from omegaconf import OmegaConf

            config = OmegaConf.load(config_path)
        except ImportError:
            from world_modelz_tpu_torch.models._gumbelvq_minimal import load_config

            config = load_config(config_path)
        try:
            from taming.models.vqgan import GumbelVQ

            model = GumbelVQ(**config.model.params)
            self.vendored = False
        except ImportError:
            from world_modelz_tpu_torch.models import _gumbelvq_minimal

            model = _gumbelvq_minimal.build(**dict(config.model.params))
            self.vendored = True
        if ckpt_path:
            sd = torch.load(ckpt_path, map_location="cpu")["state_dict"]
            model.load_state_dict(sd, strict=False)
        self.device = resolve_device(device)
        self._model = model.to(self.device).eval()
        params = config.model.params
        self.num_embeddings = int(params.n_embed)
        self._z_channels = int(params.ddconfig.z_channels)
        self.in_channels = int(params.ddconfig.get("in_channels", 3))

    @torch.no_grad()
    def encode(self, images) -> torch.Tensor:
        # [0, 1] NHWC -> [-1, 1] NCHW (sparse_diffusion_sber.py:52-55)
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        x = x.permute(0, 3, 1, 2) * 2.0 - 1.0
        _, _, (_, _, indices) = self._model.encode(x)
        b = x.shape[0]
        hw = int(np.sqrt(indices.numel() // b))
        return indices.view(b, hw, hw)

    @torch.no_grad()
    def decode(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(tokens, device=self.device).long()
        b, h, w = t.shape
        # get_codebook_entry takes a (B, H, W, C) shape spec (:162-164)
        z = self._model.quantize.get_codebook_entry(t.reshape(-1), (b, h, w, self._z_channels))
        img = (self._model.decode(z) + 1.0) * 0.5  # [-1, 1] -> [0, 1] (:57-60)
        return img.clamp(0, 1).permute(0, 2, 3, 1)


def make_tokenizer(spec: str, device: DeviceLike = None) -> FrameTokenizer:
    """A tokenizer from ``spec``:
    - ``native:<checkpoint-dir>``: a port tokenizer checkpoint;
    - ``taming:<config.yaml>,<model.ckpt>``: a taming GumbelVQ.
    ``device=None`` means ``"cuda"``."""
    kind, _, rest = spec.partition(":")
    if kind == "native":
        from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer

        tok, _ = load_tokenizer(rest, resolve_device(device))
        return NativeTokenizer(tok)
    if kind == "taming":
        config_path, _, ckpt_path = rest.partition(",")
        return TamingGumbelVQAdapter(config_path, ckpt_path, device)
    raise ValueError(f"unknown tokenizer spec {spec!r}")
