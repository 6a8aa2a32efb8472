"""Residual conv encoder/decoder stacks of the frame tokenizer.

Port of ``world_modelz_tpu.models.conv`` (reference blocks:
vq-video-diffusion/autoencoder.py:8-152). These modules are ordinary
PyTorch: NCHW inside; the tokenizer (``models/tokenizer.py``) permutes its
NHWC images at its boundary. Submodule names follow the reference
state_dict layout, so ``convert.tokenizer_state_dict_from_state`` loads
with ``strict=True``. BatchNorm (``BatchNorm2d``) is torch's in eval mode
(eps 1e-5); in training it normalizes with the biased batch variance, as
both frameworks do, and updates its running statistics as flax does
(momentum 0.9, the biased variance).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from world_modelz_tpu_torch.parallel.distributed import mean_across


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with torch's default slope 0.01 (autoencoder.py:19)."""
    return F.leaky_relu(x, negative_slope=0.01)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward updates the running
    statistics as flax's ``nn.BatchNorm(momentum=0.9)`` does:

        running_mean = 0.9 running_mean + 0.1 mean
        running_var  = 0.9 running_var  + 0.1 var   (biased, over B*H*W)

    torch's own update takes the unbiased variance (x n/(n-1)), which at a
    small batch or the deepest encoder layer is not close. The batch
    statistics come from the same fused batch-norm call that normalizes
    (into scratch buffers at momentum 1, which leaves the batch mean and
    unbiased variance there), so no extra pass over the input is made.
    ``num_batches_tracked`` is left as it is. Eval mode is torch's.

    With a ``mesh`` whose data axis has a process group (set by the
    tokenizer trainer, ``parallel.mesh.attach``), the batch statistics are
    the global batch's, as JAX's global view takes them: the moments are
    reduced over the ranks in two passes, the mean first, then the centred
    mean of squares (``torch.nn.SyncBatchNorm`` does not run on the CPU).
    """

    def __init__(self, planes: int):
        super().__init__(planes, eps=1e-5, momentum=0.1)
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None and self.mesh.group is not None:
            return self._global_forward(x)
        stats = torch.zeros((2, x.shape[1]), dtype=self.running_mean.dtype,
                            device=x.device)
        y = F.batch_norm(x, stats[0], stats[1], self.weight, self.bias,
                         training=True, momentum=1.0, eps=self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = 1.0 - self.momentum  # flax's momentum
            self.running_mean.mul_(keep).add_(stats[0], alpha=self.momentum)
            self.running_var.mul_(keep).add_(
                stats[1], alpha=self.momentum * (n - 1) / n)
        return y

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training forward over the global batch (equal per-rank batches):
        the mean of the ranks' means, then of their centred mean squares."""
        mean = mean_across(x.mean((0, 2, 3)), self.mesh)
        xc = x - mean[None, :, None, None]
        var = mean_across((xc * xc).mean((0, 2, 3)), self.mesh)
        inv = torch.rsqrt(var + self.eps)
        y = xc * (inv * self.weight)[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            keep = 1.0 - self.momentum  # flax's momentum
            self.running_mean.mul_(keep).add_(mean.detach(), alpha=self.momentum)
            self.running_var.mul_(keep).add_(var.detach(), alpha=self.momentum)
        return y


def _bn(planes: int) -> BatchNorm2d:
    return BatchNorm2d(planes)


class Residual(nn.Module):
    """Strided residual block (autoencoder.py:18-42).

    conv3x3(stride) -> BN -> LeakyReLU -> conv1x1 -> BN, added to a
    (strided, BN'd) shortcut, then LeakyReLU. Channel count is preserved.
    """

    def __init__(self, in_planes: int, hidden_planes: int, stride: int = 1):
        super().__init__()
        self._block = nn.Sequential(
            nn.Conv2d(in_planes, hidden_planes, 3, stride, padding=1, bias=False),
            _bn(hidden_planes),
            nn.LeakyReLU(0.01),
            nn.Conv2d(hidden_planes, in_planes, 1, bias=False),
            _bn(in_planes),
        )
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, in_planes, stride, stride, bias=False),
                _bn(in_planes),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        return leaky_relu(self._block(x) + residual)


class ResidualStack(nn.Module):
    """num_layers x [stride-1 block, stride-2 block]: 2x downscale per layer
    (autoencoder.py:45-57)."""

    def __init__(self, num_layers: int, in_planes: int, hidden_planes: int):
        super().__init__()
        blocks = []
        for _ in range(num_layers):
            blocks.append(Residual(in_planes, hidden_planes, stride=1))
            blocks.append(Residual(in_planes, hidden_planes, stride=2))
        self._stack = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._stack(x)


class SimpleResidualEncoder(nn.Module):
    """conv3x3 stem + residual downscale stack (autoencoder.py:60-86).

    Maps (B, C_in, H, W) -> (B, out_planes, H / 2^L, W / 2^L).
    """

    def __init__(
        self, in_channels: int, out_planes: int, num_layers: int,
        hidden_planes: int,
    ):
        super().__init__()
        self._conv_1 = nn.Conv2d(in_channels, out_planes, 3, padding=1, bias=False)
        self._residual_stack = ResidualStack(num_layers, out_planes, hidden_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._residual_stack(leaky_relu(self._conv_1(x)))


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample with half-pixel centres (NCHW), the function
    ``jax.image.resize(..., "bilinear")`` computes for a 2x enlargement."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class UpscaleResidual(nn.Module):
    """Pre-activation residual upsample block (autoencoder.py:89-131): the
    literal upsample-then-conv path (the JAX default, ``fuse_upsample=False``).
    """

    def __init__(self, in_planes: int, out_planes: int, upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.bn1 = _bn(in_planes)
        self.conv1 = nn.Conv2d(in_planes, out_planes, 3, padding=1)
        self.bn2 = _bn(out_planes)
        self.conv2 = nn.Conv2d(out_planes, out_planes, 3, padding=1)
        self.conv_residual = None
        if in_planes != out_planes or upsample:
            self.conv_residual = nn.Conv2d(in_planes, out_planes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.bn1(x))
        if self.upsample:
            h = upsample_2x(h)
        h = leaky_relu(self.bn2(self.conv1(h)))
        h = self.conv2(h)
        if self.conv_residual is not None:
            # the 1x1 projection runs at LOW resolution, before the
            # upsample: it commutes with per-channel bilinear interpolation
            # (world_modelz_tpu/models/conv.py:297-308)
            x = self.conv_residual(x)
        if self.upsample:
            x = upsample_2x(x)
        return h + x


class SimpleResidualDecoder(nn.Module):
    """conv stem + upscale residual chain + output conv
    (autoencoder.py:134-152). ``cfg`` lists the hidden channel count of each
    2x upscale stage."""

    def __init__(self, in_channels: int, cfg: Sequence[int], out_channels: int = 3):
        super().__init__()
        layers = [nn.Conv2d(in_channels, in_channels, 3, padding=1, bias=False)]
        planes = in_channels
        for hidden in cfg:
            layers.append(UpscaleResidual(planes, hidden, upsample=True))
            planes = hidden
        layers.append(nn.Conv2d(planes, out_channels, 3, padding=1, bias=False))
        self.decoder_stack = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder_stack(x)
