"""Plain PyTorch VQ tokenizer (encode, decode) and the MovingMNIST
compositor, in float32.

The architecture is the published one (vq-video-diffusion/autoencoder.py:
a conv stem and ``downscale_steps`` pairs of residual blocks, stride 1 then
stride 2, BatchNorm in eval mode; the decoder's pre-activation upscale
blocks with bilinear 2x upsampling; nearest-codebook quantization). The
parameters are read by their published state_dict names. ``round_bf16``
rounds the conv weights and the BatchNorm tensors to bfloat16 values, the
frozen tokenizer's inference cast that the training configurations state
(the codebook stays float32).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def round_bf16(params: Params) -> Params:
    """Conv and BatchNorm tensors rounded to bfloat16 values (kept f32);
    the codebook untouched."""
    return {n: (t if n.startswith("vq.") or not t.is_floating_point()
                else t.to(torch.bfloat16).to(torch.float32))
            for n, t in params.items()}


def _leaky(x):
    return F.leaky_relu(x, 0.01)


def _bn(x, p: Params, prefix: str):
    mean = p[prefix + ".running_mean"][None, :, None, None]
    var = p[prefix + ".running_var"][None, :, None, None]
    w = p[prefix + ".weight"][None, :, None, None]
    b = p[prefix + ".bias"][None, :, None, None]
    return (x - mean) / torch.sqrt(var + 1e-5) * w + b


def encoder_latents(p: Params, images: torch.Tensor, downscale_steps: int) -> torch.Tensor:
    """(N, H, W, C) images in [0, 1] -> (N, h, w, D) latents."""
    x = images.permute(0, 3, 1, 2)
    x = _leaky(F.conv2d(x, p["encoder._conv_1.weight"], padding=1))
    for i in range(2 * downscale_steps):
        stride = 1 if i % 2 == 0 else 2
        pre = f"encoder._residual_stack._stack.{i}."
        y = F.conv2d(x, p[pre + "_block.0.weight"], stride=stride, padding=1)
        y = _leaky(_bn(y, p, pre + "_block.1"))
        y = _bn(F.conv2d(y, p[pre + "_block.3.weight"]), p, pre + "_block.4")
        if stride == 1:
            res = x
        else:
            res = _bn(F.conv2d(x, p[pre + "downsample.0.weight"], stride=2), p,
                      pre + "downsample.1")
        x = _leaky(y + res)
    return x.permute(0, 2, 3, 1)


def nearest_code(latents: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the nearest code (squared Euclidean distance, float64, the
    lowest index on a tie) for each latent vector: (..., D) -> (...)."""
    flat = latents.reshape(-1, latents.shape[-1]).double()
    e = codebook.double()
    d = (flat * flat).sum(1, keepdim=True) - 2.0 * flat @ e.T + (e * e).sum(1)[None]
    return d.argmin(1).reshape(latents.shape[:-1])


def encode(p: Params, images: torch.Tensor, downscale_steps: int,
           block: int = 4096) -> torch.Tensor:
    """(N, H, W, C) images -> (N, h, w) int64 tokens, ``block`` images at a
    time."""
    out = [nearest_code(encoder_latents(p, images[i:i + block], downscale_steps),
                        p["vq.embedding"][0])
           for i in range(0, images.shape[0], block)]
    return torch.cat(out)


def _upsample(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def decode(p: Params, tokens: torch.Tensor, downscale_steps: int) -> torch.Tensor:
    """(N, h, w) tokens -> (N, H, W, C) images; out-of-range tokens (the
    mask token) clamped into the codebook."""
    codebook = p["vq.embedding"][0]
    x = codebook[tokens.long().clamp(0, codebook.shape[0] - 1)].permute(0, 3, 1, 2)
    x = F.conv2d(x, p["decoder.decoder_stack.0.weight"], padding=1)
    for i in range(1, downscale_steps + 1):
        pre = f"decoder.decoder_stack.{i}."
        h = _upsample(_leaky(_bn(x, p, pre + "bn1")))
        h = F.conv2d(h, p[pre + "conv1.weight"], p[pre + "conv1.bias"], padding=1)
        h = _leaky(_bn(h, p, pre + "bn2"))
        h = F.conv2d(h, p[pre + "conv2.weight"], p[pre + "conv2.bias"], padding=1)
        r = F.conv2d(x, p[pre + "conv_residual.weight"], p[pre + "conv_residual.bias"])
        x = h + _upsample(r)
    x = F.conv2d(x, p[f"decoder.decoder_stack.{downscale_steps + 1}.weight"], padding=1)
    return x.permute(0, 2, 3, 1)


def composite(sprites: torch.Tensor, pos: torch.Tensor, image_size: int) -> torch.Tensor:
    """Bouncing-sprite clips: (B, D, K, K) uint8 sprites and (B, D, S, 2)
    per-frame top-left (y, x) positions -> (B, S, H, W, 1) float32 frames,
    each the sum of its sprites (value / 255) placed on a zero canvas,
    parts off the canvas dropped, clamped to [0, 1]."""
    b, d, k = sprites.shape[0], sprites.shape[1], sprites.shape[-1]
    s = pos.shape[2]
    canvas = torch.zeros((b, s, image_size + 2 * k, image_size + 2 * k),
                         dtype=torch.float32, device=sprites.device)
    values = sprites.to(torch.float32) / 255.0
    places = pos.cpu().tolist()
    for i in range(b):
        for j in range(d):
            for f in range(s):
                y, x = (int(v) + k for v in places[i][j][f])
                if not (0 <= y <= image_size + k and 0 <= x <= image_size + k):
                    raise ValueError(f"sprite position {places[i][j][f]} off the canvas")
                canvas[i, f, y:y + k, x:x + k] += values[i, j]
    frames = canvas[:, :, k:k + image_size, k:k + image_size]
    return frames.clamp(0.0, 1.0)[..., None]


def param_spec(t: Dict) -> list:
    """(name, shape) of every tensor of the published tokenizer state_dict
    (``t``: embedding_dim, num_embeddings, downscale_steps, hidden_planes,
    in_channels)."""
    d, k, steps, hid, c = (t["embedding_dim"], t["num_embeddings"], t["downscale_steps"],
                           t["hidden_planes"], t["in_channels"])
    spec = [("encoder._conv_1.weight", (d, c, 3, 3))]

    def bn(prefix, n):
        spec.extend((f"{prefix}.{s}", (n,)) for s in ("weight", "bias", "running_mean",
                                                      "running_var"))

    for i in range(2 * steps):
        pre = f"encoder._residual_stack._stack.{i}."
        spec.append((pre + "_block.0.weight", (hid, d, 3, 3)))
        bn(pre + "_block.1", hid)
        spec.append((pre + "_block.3.weight", (d, hid, 1, 1)))
        bn(pre + "_block.4", d)
        if i % 2:
            spec.append((pre + "downsample.0.weight", (d, d, 2, 2)))
            bn(pre + "downsample.1", d)
    spec.append(("decoder.decoder_stack.0.weight", (d, d, 3, 3)))
    planes = d
    for i in range(1, steps + 1):
        pre = f"decoder.decoder_stack.{i}."
        bn(pre + "bn1", planes)
        spec += [(pre + "conv1.weight", (hid, planes, 3, 3)), (pre + "conv1.bias", (hid,))]
        bn(pre + "bn2", hid)
        spec += [(pre + "conv2.weight", (hid, hid, 3, 3)), (pre + "conv2.bias", (hid,)),
                 (pre + "conv_residual.weight", (hid, planes, 1, 1)),
                 (pre + "conv_residual.bias", (hid,))]
        planes = hid
    spec.append((f"decoder.decoder_stack.{steps + 1}.weight", (c, planes, 3, 3)))
    spec += [("vq.embedding", (1, k, d)), ("vq.cluster_size", (1, k))]
    return spec
