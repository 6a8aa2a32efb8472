"""Compute precisions of the plain references.

``f32``: float32 throughout (the callers turn TF32 off). ``bf16``: the
parameters cast to bfloat16 and every product in bfloat16 with float32
accumulation, softmax and loss in float32: what the configurations state
for training. ``fp8``: the control one step below bf16: the bf16 flow with
the operands of every product rounded to float8 (e4m3 forward, e5m2 for
the gradients flowing back), each tensor scaled by its own absolute
maximum, as fp8 training rounds them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = _FP8_MAX[dtype] / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


class Precision:
    """One of ``f32``, ``bf16`` or ``fp8``: the dtype the parameters are
    cast to (``dtype``) and the rounding of each product's operands."""

    def __init__(self, name: str):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float32 if name == "f32" else torch.bfloat16

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.name == "fp8" else x

    def linear(self, x, w, b=None):
        """x @ w.T (+ b): the product rounded to the working dtype, then
        the bias added in it (flax's Dense)."""
        y = F.linear(self.operand(x), self.operand(w))
        return y if b is None else y + b

    def cast(self, params):
        """The f32 master parameters as the forward reads them (a
        differentiable cast, so the gradients land in f32). Embedding
        tables stay f32: ``embed`` casts the rows it gathers, so their
        gradients are summed in f32."""
        return {n: p.to(self.dtype) if p.dtype == torch.float32 and "emb" not in n else p
                for n, p in params.items()}

    def embed(self, table, indices):
        """Rows of an (f32) embedding table, in the working dtype."""
        return table[indices].to(self.dtype)
