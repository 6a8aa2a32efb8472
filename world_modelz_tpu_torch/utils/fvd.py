"""Fréchet Video Distance (FVD) harness (port of
``world_modelz_tpu.utils.fvd``).

Real and generated clips are embedded by a feature network, a Gaussian is
fitted to each feature cloud, and the Fréchet distance between the two is

    FVD = |mu_r - mu_g|^2 + tr(S_r + S_g - 2 (S_r S_g)^{1/2})

(Unterthiner et al., "Towards Accurate Generative Models of Video", 2018).

- ``gaussian_stats``, ``frechet_distance``, ``fvd_from_features`` and
  ``fvd_bootstrap`` are host numpy in float64, copied unchanged from the
  JAX package, so the same features give the same FVD and confidence
  interval bit for bit.
- Extractors (``make_extractor``) take (B, T, H, W, C) clips in [0, 1]
  and return (B, D) f32 features, on the extractor's device (the GPU
  unless ``device="cpu"``), with TF32 off inside the call:
  - ``tiny``: a fixed random 3-D conv net (``tiny_video_features``) whose
    weights are JAX's ``PRNGKey(42)`` draws, replayed in numpy
    (``utils/jax_prng.py``); useful for trends between checkpoints, not
    comparable to published FVD scores;
  - ``tokenizer``: pooled pre-quantization latents of a trained tokenizer
    (``make_tokenizer_extractor``);
  - ``i3d``: the Kinetics-400 Inflated Inception-V1 network behind
    published FVD (``I3D``), whose weights ``load_i3d`` reads from an
    ``.npz`` in the JAX package's layout (``weights=`` or
    ``WMZ_I3D_WEIGHTS``); clips are resized to 224 x 224 as
    ``jax.image.resize(..., "linear")`` resizes them (antialiased when
    shrinking).
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from world_modelz_tpu_torch._device import DeviceLike, resolve_device
from torch import nn

from world_modelz_tpu_torch.utils import jax_prng

Extractor = Callable[[torch.Tensor], torch.Tensor]  # (B,T,H,W,C)->(B,D)


# ---------------------------------------------------------------------------
# Fréchet distance (host numpy, float64; the JAX package's code unchanged)
# ---------------------------------------------------------------------------


def gaussian_stats(feats) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of an (N, D) feature matrix, in float64."""
    f = np.asarray(feats, dtype=np.float64)
    mu = f.mean(axis=0)
    d = f - mu
    sigma = (d.T @ d) / max(f.shape[0] - 1, 1)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians, without scipy.

    tr((S1 S2)^{1/2}) through symmetric eigendecompositions: with
    E = S1^{1/2} (by eigh), M = E S2 E is PSD and similar to S1 S2, so
    tr((S1 S2)^{1/2}) = sum(sqrt(eigvalsh(M))). Eigenvalues are clamped at
    zero; ``eps`` ridges both covariances.
    """
    mu1 = np.asarray(mu1, dtype=np.float64)
    mu2 = np.asarray(mu2, dtype=np.float64)
    d = mu1 - mu2
    eye = np.eye(sigma1.shape[0])
    s1 = np.asarray(sigma1, dtype=np.float64) + eps * eye
    s2 = np.asarray(sigma2, dtype=np.float64) + eps * eye

    w1, v1 = np.linalg.eigh(s1)
    sqrt_s1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    m = sqrt_s1 @ s2 @ sqrt_s1
    m = (m + m.T) / 2.0
    covmean_trace = np.sum(
        np.sqrt(np.clip(np.linalg.eigvalsh(m), 0.0, None))
    )
    return float(
        d @ d + np.trace(s1) + np.trace(s2) - 2.0 * covmean_trace
    )


def fvd_from_features(real_feats, gen_feats) -> float:
    """FVD between two (N, D) feature matrices."""
    mu_r, s_r = gaussian_stats(real_feats)
    mu_g, s_g = gaussian_stats(gen_feats)
    return frechet_distance(mu_r, s_r, mu_g, s_g)


def fvd_bootstrap(
    real_feats,
    gen_feats,
    n_boot: int = 200,
    seed: int = 0,
    ci: float = 0.95,
) -> Tuple[float, float, float]:
    """FVD point estimate and a bootstrap confidence interval: (fvd, lo,
    hi).

    Clips are resampled with replacement on both sides. The interval is
    the bootstrap samples' spread around their own mean, anchored at the
    point estimate (``point + q_{a/2..1-a/2}(samples - mean(samples))``),
    since resampling biases FVD upward by a roughly constant amount; lo
    and hi clamp at 0.
    """
    real_feats = np.asarray(real_feats)
    gen_feats = np.asarray(gen_feats)
    point = fvd_from_features(real_feats, gen_feats)
    rng = np.random.default_rng(seed)
    n_r, n_g = len(real_feats), len(gen_feats)
    samples = np.empty(n_boot)
    for i in range(n_boot):
        rs = real_feats[rng.integers(0, n_r, n_r)]
        gs = gen_feats[rng.integers(0, n_g, n_g)]
        samples[i] = fvd_from_features(rs, gs)
    alpha = (1.0 - ci) / 2.0
    d_lo, d_hi = np.quantile(samples - samples.mean(), [alpha, 1.0 - alpha])
    lo = max(0.0, point + d_lo)
    hi = max(0.0, point + d_hi)
    return float(point), float(lo), float(hi)


# ---------------------------------------------------------------------------
# Extractors
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def tf32_off():
    """Full-f32 matmuls and convolutions inside the block (the features of
    one clip do not depend on PyTorch's TF32 settings); the settings are
    restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


_TINY_CHANNELS = ((3, 32), (32, 64), (64, None))  # None: the feature width
_TINY_STRIDES = ((1, 2, 2), (2, 2, 2), (2, 2, 2))


@functools.lru_cache(maxsize=4)
def tiny_weights(dim: int = 128) -> Tuple[np.ndarray, ...]:
    """The ``tiny`` net's three (3, 3, 3, ci, co) f32 kernels: JAX's
    ``jax.random.normal`` under ``split(PRNGKey(42), 4)``, scaled by
    sqrt(2 / (27 ci)) (``utils/fvd.py:_tiny_forward``)."""
    keys = jax_prng.split(jax_prng.prng_key(42), 4)
    out = []
    for key, (ci, co) in zip(keys, _TINY_CHANNELS):
        w = jax_prng.normal(key, (3, 3, 3, ci, co or dim))
        out.append(w * np.float32(np.sqrt(2.0 / (27 * ci))))
    return tuple(out)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` for one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def tiny_video_features(videos: torch.Tensor, dim: int = 128) -> torch.Tensor:
    """Deterministic (B, 2 dim) features (per-channel mean and population
    std) of a fixed random 3-D conv net; videos (B, T, H, W, C) in [0, 1]
    are resized to 32 x 32 (bilinear, antialiased as ``jax.image.resize``)
    and mapped to [-1, 1]."""
    b, t, h, w, c = videos.shape
    x = videos.to(torch.float32)
    if c == 1:
        x = x.repeat(1, 1, 1, 1, 3)
    elif c != 3:
        x = x[..., :3]
    if (h, w) != (32, 32):
        x = F.interpolate(x.reshape(b * t, h, w, 3).permute(0, 3, 1, 2),
                          size=(32, 32), mode="bilinear", align_corners=False,
                          antialias=True)
        x = x.permute(0, 2, 3, 1).reshape(b, t, 32, 32, 3)
    x = (x * 2.0 - 1.0).permute(0, 4, 1, 2, 3)  # (B, C, T, H, W)
    with tf32_off():
        for wgt, stride in zip(tiny_weights(dim), _TINY_STRIDES):
            k = torch.from_numpy(wgt).to(x.device).permute(4, 3, 0, 1, 2)
            pads = [p for n, s in zip(reversed(x.shape[2:]), reversed(stride))
                    for p in _same_pads(n, 3, s)]
            x = F.relu(F.conv3d(F.pad(x, pads), k, stride=stride))
    mean = x.mean(dim=(2, 3, 4))
    std = x.std(dim=(2, 3, 4), correction=0)
    return torch.cat([mean, std], dim=-1)


# ---------------------------------------------------------------------------
# I3D (Inflated Inception-V1, Kinetics-400): the canonical FVD network
# ---------------------------------------------------------------------------


def _pad_same(x: torch.Tensor, kernel, stride, value: float = 0.0) -> torch.Tensor:
    """XLA's ``padding="SAME"`` on the (T, H, W) axes of a (B, C, T, H, W)
    tensor: more at the end where the total is odd (flax's conv and
    max_pool; F.conv3d's symmetric ``padding=`` differs at stride 2)."""
    pads = [p for n, k, s in zip(reversed(x.shape[2:]), reversed(kernel), reversed(stride))
            for p in _same_pads(n, k, s)]
    return F.pad(x, pads, value=value) if any(pads) else x


def _max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """flax ``nn.max_pool(..., padding="SAME")``: padded with -inf."""
    return F.max_pool3d(_pad_same(x, kernel, stride, float("-inf")), kernel, stride)


class _FrozenBatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True, epsilon=1e-3)`` over the
    channel axis 1: (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        return (x - self.mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class Unit3D(nn.Module):
    """Conv3D (SAME padding) + frozen BatchNorm + ReLU, the I3D building
    block (JAX ``Unit3D``); ``use_bn=False`` gives the conv a bias."""

    def __init__(self, cin: int, features: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, activation: bool = True):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv = nn.Conv3d(cin, features, self.kernel, self.stride, bias=not use_bn)
        self.bn = _FrozenBatchNorm(features) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(_pad_same(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionBlock(nn.Module):
    """Four-branch inception mixing unit (I3D 'Mixed_*'); ``channels`` is
    (b0, b1a, b1b, b2a, b2b, b3)."""

    def __init__(self, cin: int, channels: Sequence[int]):
        super().__init__()
        c = channels
        self.b0 = Unit3D(cin, c[0])
        self.b1a = Unit3D(cin, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(cin, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(cin, c[5])
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(_max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], 1)


_I3D_MIXED = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)
# max pools (kernel, stride) before these blocks (JAX ``I3D.__call__``)
_I3D_POOL_BEFORE = {"Mixed_3b": ((1, 3, 3), (1, 2, 2)),
                    "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
                    "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class I3D(nn.Module):
    """Inflated Inception-V1 video classifier (Carreira & Zisserman 2017),
    the JAX ``I3D`` with its module names: input (B, T, H, W, 3) in
    [-1, 1], output (B, num_classes) time-mean logits, the feature space of
    the published FVD. Parameters start at the conv's default init and BN's
    identity; ``load_i3d`` reads real weights."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, channels in _I3D_MIXED:
            block = InceptionBlock(cin, channels)
            setattr(self, name, block)
            cin = block.out_channels
        self.logits = Unit3D(cin, num_classes, use_bn=False, activation=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)  # (B, C, T, H, W)
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        for name, _ in _I3D_MIXED:
            if name in _I3D_POOL_BEFORE:
                x = _max_pool_same(x, *_I3D_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        # spatial mean (time kept), the 1x1x1 logits conv, then the time mean
        x = self.logits(x.mean(dim=(3, 4), keepdim=True))
        return x[:, :, :, 0, 0].mean(dim=2)


def _i3d_key(name: str) -> str:
    """A state_dict key -> its '/'-joined flax path."""
    *mods, leaf = name.split(".")
    if leaf in ("mean", "var"):
        return "/".join(["batch_stats", *mods, leaf])
    return "/".join(["params", *mods, "kernel" if leaf == "weight" else leaf])


def _jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A conv weight (O, I, T, H, W) as flax's kernel (T, H, W, I, O)."""
    return t.permute(2, 3, 4, 1, 0) if name.endswith("conv.weight") else t


def i3d_param_paths(model: Optional[I3D] = None) -> List[str]:
    """The '/'-joined flax tree paths an I3D weights .npz must provide
    (JAX ``i3d_param_paths``), sorted."""
    model = model if model is not None else I3D()
    return sorted(_i3d_key(k) for k in model.state_dict())


def load_i3d(weights_path: str, device: DeviceLike = None) -> I3D:
    """An I3D in eval mode, on ``device`` (the GPU unless ``"cpu"``), with
    the weights of an .npz keyed by flax tree paths (JAX ``load_i3d``):
    ``params/<block>/conv/kernel`` in (T, H, W, I, O), ``.../bn/scale|bias``,
    ``batch_stats/.../bn/mean|var``; the logits conv's ``conv/bias``. A
    missing array or a wrong shape raises ``ValueError``, as in JAX."""
    dev = resolve_device(device)
    model = I3D()
    state = model.state_dict()
    with np.load(weights_path) as archive:
        expected = i3d_param_paths(model)
        missing = [k for k in expected if k not in archive.files]
        if missing:
            raise ValueError(
                f"I3D weights file {weights_path} is missing "
                f"{len(missing)} arrays, e.g. {missing[:5]}"
            )
        loaded: Dict[str, torch.Tensor] = {}
        for name, cur in state.items():
            key = _i3d_key(name)
            arr = torch.from_numpy(np.array(archive[key], dtype=np.float32))
            want = tuple(_jax_layout(name, cur).shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: shape {tuple(arr.shape)} != expected {want}")
            loaded[name] = (arr.permute(4, 3, 0, 1, 2) if name.endswith("conv.weight")
                            else arr)
    model.load_state_dict(loaded, strict=True)
    return model.to(dev).eval()


def save_i3d(model: I3D, path: str) -> None:
    """Write ``model``'s weights as an .npz in the layout ``load_i3d`` (and
    the JAX package's ``load_i3d``) reads."""
    np.savez(path, **{_i3d_key(k): _jax_layout(k, v).detach().cpu().numpy()
                      for k, v in model.state_dict().items()})


def resize_224(videos: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, 224, 224, C) as ``jax.image.resize(...,
    "linear")``: bilinear at half-pixel centres, antialiased along an axis
    that shrinks (a triangle kernel widened by the scale)."""
    b, t, h, w, c = videos.shape
    x = videos.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(224, 224), mode="bilinear", align_corners=False,
                      antialias=h > 224 or w > 224)
    return x.permute(0, 2, 3, 1).reshape(b, t, 224, 224, c)


@torch.no_grad()
def i3d_features(model: I3D, videos: torch.Tensor) -> torch.Tensor:
    """I3D logits features (JAX ``i3d_features``): videos (B, T, H, W, C) in
    [0, 1] (one channel repeated to three), resized to 224 x 224, mapped to
    [-1, 1]; TF32 off inside."""
    x = videos.to(next(model.parameters()).device, torch.float32)
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 1, 3)
    if tuple(x.shape[2:4]) != (224, 224):
        x = resize_224(x)
    with tf32_off():
        return model(x * 2.0 - 1.0)


def make_tokenizer_extractor(checkpoint: str, device: DeviceLike = None) -> Extractor:
    """Features from a trained tokenizer's pre-quantization latents
    (``VQAutoEncoder.encode_continuous``, eval mode, the f32 tokenizer as
    the checkpoint holds it): per clip, the time mean of the per-frame
    spatial mean and std of the (h', w', D) latents, of the spatial mean
    of |z_t - z_{t-1}| (motion) and of |(z_{t+1} - z_t) - (z_t - z_{t-1})|
    (acceleration) -> (4 D,) features."""
    from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer

    tok, _ = load_tokenizer(checkpoint, device)

    def feats(videos: torch.Tensor) -> torch.Tensor:
        n, t, h, w, c = videos.shape
        with tf32_off():
            z = tok.encode_continuous(
                videos.to(tok.device, torch.float32).reshape(n * t, h, w, c))
        z = z.reshape(n, t, *z.shape[1:])  # (N, T, h', w', D)
        mean = z.mean(dim=(2, 3))  # (N, T, D)
        std = z.std(dim=(2, 3), correction=0)
        vel = z[:, 1:] - z[:, :-1]
        motion = vel.abs().mean(dim=(2, 3))
        accel = (vel[:, 1:] - vel[:, :-1]).abs().mean(dim=(2, 3))
        return torch.cat([mean.mean(1), std.mean(1), motion.mean(1),
                          accel.mean(1)], dim=-1)

    return feats


def make_extractor(
    name: str = "tiny", weights: Optional[str] = None, device: DeviceLike = None
) -> Extractor:
    """A feature extractor by name (``tiny``, ``i3d`` or ``tokenizer``).
    ``i3d`` reads its .npz from ``weights`` (or ``WMZ_I3D_WEIGHTS``),
    ``tokenizer`` the checkpoint path (or ``WMZ_TOKENIZER_EXTRACTOR``)."""
    dev = resolve_device(device)
    if name == "tiny":
        return lambda videos: tiny_video_features(videos.to(dev))
    if name == "tokenizer":
        weights = weights or os.environ.get("WMZ_TOKENIZER_EXTRACTOR", "")
        if not weights:
            raise ValueError(
                "tokenizer extractor needs a tokenizer checkpoint: pass "
                "weights= or set WMZ_TOKENIZER_EXTRACTOR"
            )
        return make_tokenizer_extractor(weights, dev)
    if name == "i3d":
        weights = weights or os.environ.get("WMZ_I3D_WEIGHTS", "")
        if not weights:
            raise ValueError(
                "i3d extractor needs pretrained weights: pass weights= or "
                "set WMZ_I3D_WEIGHTS (zero-egress: mount the converted "
                ".npz; see load_i3d docstring)"
            )
        model = load_i3d(weights, dev)
        return functools.partial(i3d_features, model)
    raise ValueError(
        f"unknown extractor {name!r} (use 'tiny', 'i3d', or 'tokenizer')"
    )


@torch.no_grad()
def extract_features(
    extractor: Extractor, videos: np.ndarray, batch_size: int = 16
) -> np.ndarray:
    """Batched (N, T, H, W, C) -> (N, D) f32 features (host loop)."""
    out: List[np.ndarray] = []
    for i in range(0, len(videos), batch_size):
        batch = torch.as_tensor(np.asarray(videos[i : i + batch_size]))
        out.append(extractor(batch).float().cpu().numpy())
    return np.concatenate(out, axis=0)


def fvd(
    real_videos: np.ndarray,
    gen_videos: np.ndarray,
    extractor: Optional[Extractor] = None,
    batch_size: int = 16,
) -> float:
    """FVD between two clip sets (N, T, H, W, C) in [0, 1] of one shape;
    the ``tiny`` extractor on the GPU by default."""
    if real_videos.shape[1:] != gen_videos.shape[1:]:
        raise ValueError(
            f"clip shapes differ: real {real_videos.shape[1:]} vs "
            f"generated {gen_videos.shape[1:]}"
        )
    extractor = extractor or make_extractor("tiny")
    real_f = extract_features(extractor, real_videos, batch_size)
    gen_f = extract_features(extractor, gen_videos, batch_size)
    return fvd_from_features(real_f, gen_f)
