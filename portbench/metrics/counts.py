"""The work a metric divides by: model FLOPs, the kernels' needed bytes and
products, and the card's peaks.

The FLOP formulas and the peak table are frozen copies of
``world_modelz_tpu_torch/utils/flops.py`` (``DEVICE_PEAKS``,
``local3d_transformer_flops``, ``dense_transformer_flops``,
``train_step_flops``) as they stood when this benchmark was defined, so a
later change to the program cannot change the yardstick. One change: the
local-3D attention counts the query-key pairs inside the window, clipped
at the clip's edges (``window_pairs``), where the program's copy counts the
full window for every query. A matmul of M outputs over K-long dot products
counts 2 M K FLOPs; elementwise work is not counted.

A kernel's bound is what the algorithm needs at the cell's shapes, never
what an implementation executes: each input read once and each output
written once from HBM, or the products at the peak of the operands' type,
whichever takes longer.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA's H100 Tensor Core GPU data sheet, SXM5 column, dense: tensor-core
# bf16 and TF32, CUDA-core f32, HBM bytes/s (copied from
# world_modelz_tpu_torch/utils/flops.py:DEVICE_PEAKS).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.0e12, "tf32_flops": 495.0e12,
                              "f32_flops": 67.0e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> Dict[str, float]:
    """The peaks of the card named ``kind``; KeyError for any other card."""
    return DEVICE_PEAKS[kind]


def window_pairs(shape: Tuple[int, int, int], extents: Tuple[int, int, int]) -> int:
    """Query-key pairs of one clip's windowed attention: for each axis, the
    pairs of positions at most its extent apart, multiplied over the three
    axes."""
    total = 1
    for n, e in zip(shape, extents):
        total *= sum(min(n - 1, i + e) - max(0, i - e) + 1 for i in range(n))
    return total


def local3d_transformer_flops(batch: int, shape: Tuple[int, int, int], dim: int, depth: int,
                              heads: int, dim_head: int, mlp_dim: int,
                              extents: Tuple[int, int, int], num_classes: int) -> int:
    """Forward FLOPs of the local-3D denoiser (the logits of the last frame
    only)."""
    s, h, w = shape
    n = batch * s * h * w
    inner = heads * dim_head
    pairs = batch * window_pairs(shape, extents)
    per_layer = (3 * 2 * n * dim * inner
                 + 2 * 2 * pairs * inner
                 + (2 * n * inner * dim if not (heads == 1 and dim_head == dim) else 0)
                 + 2 * 2 * n * dim * mlp_dim)
    return depth * per_layer + 2 * batch * h * w * dim * num_classes


def dense_transformer_flops(batch: int, n_tokens: int, dim: int, depth: int, heads: int,
                            dim_head: int, mlp_dim: int, num_classes: int) -> int:
    """Forward FLOPs of the sparse denoiser over ``n_tokens`` a row."""
    n = batch * n_tokens
    inner = heads * dim_head
    per_layer = (2 * n * dim * 3 * inner
                 + 2 * 2 * batch * n_tokens * n_tokens * inner
                 + (2 * n * inner * dim if not (heads == 1 and dim_head == dim) else 0)
                 + 2 * 2 * n * dim * mlp_dim)
    return depth * per_layer + 2 * n * dim * num_classes


def train_step_flops(forward_flops: int) -> int:
    """Forward and backward: three forwards, no recomputation counted."""
    return 3 * forward_flops


def bound_seconds(nbytes: float, flops: float, kind: str, dtype: str) -> float:
    """The least time of a kernel: its bytes at the HBM rate or its FLOPs at
    the peak of ``dtype`` (``bf16``, ``tf32`` or ``f32``), the larger."""
    p = peaks(kind)
    return max(nbytes / p["hbm_bytes_per_s"], flops / p[f"{dtype}_flops"])


def local3d_work(batch: int, shape, heads: int, dim_head: int, extents, itemsize: int
                 ) -> Dict[str, Tuple[float, float]]:
    """(bytes, FLOPs) the local-3D attention of one layer needs at these
    shapes. Forward: q, k, v read, the output and the row log-sum-exp
    (f32) written; QK^T and PV over the window's pairs. Backward: q, k, v,
    the output, its gradient and the log-sum-exp read, dq, dk, dv written;
    the four products dV, dP, dQ, dK over the pairs."""
    s, h, w = shape
    rows = batch * s * h * w
    elems = rows * heads * dim_head
    pairs = batch * window_pairs(shape, extents) * heads
    stats = rows * heads * 4
    return {"fwd": (4 * elems * itemsize + stats, 4.0 * pairs * dim_head),
            "bwd": (8 * elems * itemsize + stats, 8.0 * pairs * dim_head)}


def flash_work(batch: int, heads: int, n: int, dim_head: int, itemsize: int
               ) -> Dict[str, Tuple[float, float]]:
    """(bytes, FLOPs) of full softmax attention over ``n`` tokens, counted
    as ``local3d_work`` counts them with every pair in the window."""
    elems = batch * heads * n * dim_head
    pairs = batch * heads * n * n
    stats = batch * heads * n * 4
    return {"fwd": (4 * elems * itemsize + stats, 4.0 * pairs * dim_head),
            "bwd": (8 * elems * itemsize + stats, 8.0 * pairs * dim_head)}


def model_step_flops(cfg: Dict, batch: int) -> int:
    """Training FLOPs of one step of the configuration's denoiser at
    ``batch`` (its ``model``: ``local3d`` or ``sparse``)."""
    k = cfg["tokenizer"]["num_embeddings"]
    if cfg["model"] == "local3d":
        grid = cfg["image_size"] // 2 ** cfg["tokenizer"]["downscale_steps"]
        fwd = local3d_transformer_flops(batch, (cfg["n_past"] + 1, grid, grid), cfg["dim"],
                                        cfg["depth"], cfg["heads"], cfg["dim_head"],
                                        cfg["mlp_dim"], tuple(cfg["extents"]), k)
    elif cfg["model"] == "sparse":
        fwd = dense_transformer_flops(batch, cfg["num_context"], cfg["dim"], cfg["depth"],
                                      cfg["heads"], cfg["dim"] // cfg["heads"],
                                      cfg["mlp_dim"], k)
    else:
        raise ValueError(f"no FLOP count for model {cfg['model']!r}")
    return train_step_flops(fwd)


def _conv2d(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1):
    oh, ow = h // stride, w // stride
    return 2 * oh * ow * cin * cout * k * k, oh, ow


def vqae_encode_flops(image_hw: Tuple[int, int], in_channels: int, embedding_dim: int,
                      hidden_planes: int, downscale_steps: int) -> int:
    """Per-image FLOPs of the tokenizer's encoder (copied from
    world_modelz_tpu_torch/utils/flops.py:vqae_encode_flops)."""
    h, w = image_hw
    total, c = 0, in_channels
    f, h, w = _conv2d(h, w, c, embedding_dim, 3)
    total += f
    c = embedding_dim
    for _ in range(downscale_steps):
        f1, _, _ = _conv2d(h, w, c, hidden_planes, 3)
        f2, _, _ = _conv2d(h, w, hidden_planes, c, 1)
        f3, h2, w2 = _conv2d(h, w, c, hidden_planes, 3, stride=2)
        f4, _, _ = _conv2d(h2, w2, hidden_planes, c, 1)
        f5 = 2 * h2 * w2 * c * c * 2 * 2
        total += f1 + f2 + f3 + f4 + f5
        h, w = h2, w2
    return total


def vqae_decode_flops(image_hw: Tuple[int, int], in_channels: int, embedding_dim: int,
                      hidden_planes: int, downscale_steps: int) -> int:
    """Per-image FLOPs of the tokenizer's decoder at the output size
    ``image_hw`` (copied from world_modelz_tpu_torch/utils/flops.py:
    vqae_decode_flops)."""
    f0 = 2 ** downscale_steps
    h, w = image_hw[0] // f0, image_hw[1] // f0
    total, c = 0, embedding_dim
    f, _, _ = _conv2d(h, w, c, c, 3)
    total += f
    for _ in range(downscale_steps):
        f3, _, _ = _conv2d(h, w, c, hidden_planes, 1)
        h, w = h * 2, w * 2
        f1, _, _ = _conv2d(h, w, c, hidden_planes, 3)
        f2, _, _ = _conv2d(h, w, hidden_planes, hidden_planes, 3)
        total += f1 + f2 + f3
        c = hidden_planes
    f, _, _ = _conv2d(h, w, c, in_channels, 3)
    return total + f


def serve_clip_flops(cfg: Dict) -> int:
    """Model FLOPs of serving one clip: the seed frames' encode and nearest
    code search, ``num_iterations`` denoiser forwards a generated frame,
    and the decode of the generated frames."""
    t, sv = cfg["tokenizer"], cfg["serve"]
    img = (cfg["image_size"], cfg["image_size"])
    seq = cfg["n_past"] + 1
    grid = cfg["image_size"] // 2 ** t["downscale_steps"]
    widths = (t["in_channels"], t["embedding_dim"], t["hidden_planes"], t["downscale_steps"])
    encode = seq * (vqae_encode_flops(img, *widths)
                    + 2 * grid * grid * t["num_embeddings"] * t["embedding_dim"])
    forward = local3d_transformer_flops(1, (seq, grid, grid), cfg["dim"], cfg["depth"],
                                        cfg["heads"], cfg["dim_head"], cfg["mlp_dim"],
                                        tuple(cfg["extents"]), t["num_embeddings"])
    steps = sv["num_frames"] * sv["num_iterations"]
    return encode + steps * forward + sv["num_frames"] * vqae_decode_flops(img, *widths)
