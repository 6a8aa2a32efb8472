"""Seeded weights, made on the device in one draw.

``make_weights(spec, seed, device)`` cuts one standard-normal vector,
drawn on ``device`` from a fixed pool seed, into f32 tensors for the
(name, shape) pairs of ``spec``, shuffles each tensor's values by the
seed (``torch.randperm`` on a generator seeded with it), and scales each
by the rule its name and shape call for. Every seed thus gets the same
values in each tensor, in another order, so that no seed's draw changes
the work. The same seed on the same device gives the same weights, so the
program and the plain reference are handed one set.

The rules (the published models' own initialisers, as near as one draw
allows): a matrix (out, in) N(0, 1/in); a convolution N(0, 2/fan_in) (He,
for the LeakyReLU stacks); an embedding table N(0, 1/width); a norm's scale
1 + N(0, 0.1^2) and every bias or shift N(0, 0.02^2); BatchNorm's running
mean N(0, 0.02^2) and running variance 1; the VQ codebook N(0, 1) and its
cluster sizes 1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...]]]


def _scale_shift(name: str, shape) -> Tuple[float, float]:
    """(std, mean) of the tensor ``name``."""
    if name.endswith("running_var") or name.endswith("cluster_size"):
        return 0.0, 1.0
    if name.endswith("running_mean") or name.endswith("bias"):
        return 0.02, 0.0
    if name == "vq.embedding":
        return 1.0, 0.0
    if len(shape) == 1:  # a norm's scale
        return 0.1, 1.0
    if len(shape) == 4:
        fan_in = shape[1] * shape[2] * shape[3]
        return math.sqrt(2.0 / fan_in), 0.0
    return 1.0 / math.sqrt(shape[-1]), 0.0  # a matrix (out, in) or an embedding table


POOL_SEED = 20260418


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    sizes = [math.prod(shape) for _, shape in spec]
    pool = torch.randn(sum(sizes), dtype=torch.float32, device=device,
                       generator=torch.Generator(device=device).manual_seed(POOL_SEED))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out, at = {}, 0
    for (name, shape), n in zip(spec, sizes):
        std, mean = _scale_shift(name, shape)
        values = pool[at:at + n][torch.randperm(n, generator=gen, device=device)]
        out[name] = (values * std + mean).reshape(shape)
        at += n
    return out
