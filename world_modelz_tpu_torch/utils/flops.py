"""Analytic FLOP counts and the card's peaks, for MFU accounting.

Port of ``world_modelz_tpu.utils.flops``: the same FLOP counts (the same
integers, as plain Python) of the exact architectures, so that a measured
time divided by a count and by the card's peak gives the model FLOPs
utilization. A matmul or convolution of M outputs with K-long dot products
counts 2*M*K FLOPs; elementwise work (norms, activations, upsampling) is
not counted, so MFU is a matmul-utilization figure. ``device_peak`` gives
the public peaks of the card the port runs on (None on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

# Peaks per CUDA device name, matched exactly: dense tensor-core bf16 and
# TF32, CUDA-core f32, and the HBM rate, from NVIDIA's H100 Tensor Core GPU
# data sheet (H100 SXM5 column; the sparse figures halved), the figures
# chip_smoke.py's bounds use. Only the SXM5 card's name is listed: the PCIe
# and NVL cards have lower peaks, and get None rather than these.
# ``hbm_gbps`` keeps the JAX module's key, but its unit is bytes/s.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.0e12, "tf32_flops": 495.0e12,
                    "f32_flops": 67.0e12, "hbm_gbps": 3.35e12},
}


def device_peak() -> Optional[dict]:
    """The peak spec of CUDA device 0 (``torch.cuda.get_device_name()``),
    or None without a card or for a card not in ``DEVICE_PEAKS``."""
    import torch

    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name()
    spec = DEVICE_PEAKS.get(kind)
    return None if spec is None else {"device": kind, **spec}


def mfu(flops: float, seconds: float, peak_flops: Optional[float]) -> Optional[float]:
    """Model FLOPs utilization in percent, or None without a peak."""
    if not peak_flops or seconds <= 0:
        return None
    return 100.0 * flops / seconds / peak_flops


def _conv2d(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1):
    """FLOPs and output spatial dims of one conv layer (padding='same')."""
    oh, ow = h // stride, w // stride
    return 2 * oh * ow * cin * cout * k * k, oh, ow


def vqae_encode_flops(
    image_hw: Tuple[int, int],
    in_channels: int,
    embedding_dim: int,
    hidden_planes: int,
    downscale_steps: int,
) -> int:
    """Per-image FLOPs of SimpleResidualEncoder; the VQ distance search is
    not included (see :func:`vq_search_flops`). Mirrors models/conv.py."""
    h, w = image_hw
    total, c = 0, in_channels
    f, h, w = _conv2d(h, w, c, embedding_dim, 3)  # stem
    total += f
    c = embedding_dim
    for _ in range(downscale_steps):
        # Residual stride 1: conv3x3 c->hidden, conv1x1 hidden->c
        f1, _, _ = _conv2d(h, w, c, hidden_planes, 3)
        f2, _, _ = _conv2d(h, w, hidden_planes, c, 1)
        # Residual stride 2: conv3x3 s2, conv1x1, shortcut conv2x2 s2
        f3, h2, w2 = _conv2d(h, w, c, hidden_planes, 3, stride=2)
        f4, _, _ = _conv2d(h2, w2, hidden_planes, c, 1)
        f5 = 2 * h2 * w2 * c * c * 2 * 2
        total += f1 + f2 + f3 + f4 + f5
        h, w = h2, w2
    return total


def vqae_decode_flops(
    image_hw: Tuple[int, int],
    in_channels: int,
    embedding_dim: int,
    hidden_planes: int,
    downscale_steps: int,
) -> int:
    """Per-image FLOPs of SimpleResidualDecoder (models/conv.py:135-149);
    `image_hw` is the OUTPUT resolution."""
    f0 = 2**downscale_steps
    h, w = image_hw[0] // f0, image_hw[1] // f0
    total, c = 0, embedding_dim
    f, _, _ = _conv2d(h, w, c, c, 3)  # stem at latent res
    total += f
    for _ in range(downscale_steps):
        # skip projection runs at LOW res (models/conv.py commute)
        f3, _, _ = _conv2d(h, w, c, hidden_planes, 1)
        h, w = h * 2, w * 2  # UpscaleResidual convs at the upsampled res
        f1, _, _ = _conv2d(h, w, c, hidden_planes, 3)
        f2, _, _ = _conv2d(h, w, hidden_planes, hidden_planes, 3)
        total += f1 + f2 + f3
        c = hidden_planes
    f, _, _ = _conv2d(h, w, c, in_channels, 3)
    total += f
    return total


def vq_search_flops(n: int, k: int, d: int, one_hot_decode: bool = False) -> int:
    """Nearest-codebook search: the x @ E^T score matmul (ops/vq.py). The
    optional one-hot decode matmul doubles it (the JAX package's kernels/vq_kernels.py:44-57)."""
    f = 2 * n * k * d
    return 2 * f if one_hot_decode else f


def local3d_attention_flops(
    n_queries: int,
    extents: Tuple[int, int, int],
    inner_dim: int,
) -> int:
    """QK^T + AV over the full (2e+1)^3 window per query (border queries see
    clipped windows; this counts the full window, a <= 2x upper bound, as
    the JAX package counts it)."""
    window = 1
    for e in extents:
        window *= 2 * e + 1
    return 2 * 2 * n_queries * window * inner_dim


def local3d_transformer_flops(
    batch: int,
    data_shape: Tuple[int, int, int],
    dim: int,
    depth: int,
    heads: int,
    dim_head: int,
    mlp_dim: int,
    extents: Tuple[int, int, int],
    num_classes: int = 0,
    last_frame_head: bool = True,
) -> int:
    """Forward FLOPs of VqVideoDiffusionModel (models/video.py:26-67)."""
    s, h, w = data_shape
    n = batch * s * h * w
    inner = heads * dim_head
    per_layer = (
        3 * 2 * n * dim * inner  # to_q, to_k, to_v
        + local3d_attention_flops(n, extents, inner)
        + (2 * n * inner * dim if not (heads == 1 and dim_head == dim) else 0)
        + 2 * 2 * n * dim * mlp_dim  # FeedForward in+out
    )
    total = depth * per_layer
    if num_classes:
        n_head = batch * h * w if last_frame_head else n
        total += 2 * n_head * dim * num_classes
    return total


def dense_transformer_flops(
    batch: int,
    n_tokens: int,
    dim: int,
    depth: int,
    heads: int,
    dim_head: int,
    mlp_dim: int,
    num_classes: int = 0,
) -> int:
    """Forward FLOPs of VqSparseDiffusionModel (models/video.py:69-...)."""
    n = batch * n_tokens
    inner = heads * dim_head
    per_layer = (
        2 * n * dim * (3 * inner)  # fused qkv
        + 2 * 2 * batch * n_tokens * n_tokens * inner  # scores + AV
        + (2 * n * inner * dim if not (heads == 1 and dim_head == dim) else 0)
        + 2 * 2 * n * dim * mlp_dim
    )
    total = depth * per_layer
    if num_classes:
        total += 2 * n * dim * num_classes
    return total


def train_step_flops(forward_flops: int, checkpointed: bool = False) -> int:
    """fwd + bwd ~= 3x forward; activation rematerialization adds ~1 forward
    for the checkpointed segments (we checkpoint the whole attention inner
    block, so count 4x)."""
    return (4 if checkpointed else 3) * forward_flops
