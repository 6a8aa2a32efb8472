"""flax ``nn.Dense``'s compute contract (plain PyTorch), shared by the
model layers (``models/attention.py``) and the fused block's backward
(``kernels/local3d_block.py``), and the route that sends f32 forward passes
without autograd on the card to the split-TF32 kernel
(``kernels/dense_tf32.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def narrow(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` is a floating type below f32 (bf16): products of
    such operands accumulate in f32 and round to it afterwards."""
    return dtype.is_floating_point and torch.finfo(dtype).bits < 32


def dense_apply(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor = None
) -> torch.Tensor:
    """As the JAX package's ``_dense_apply`` (models/attention.py:424-431)
    and flax's ``nn.Dense``: input and parameters promoted to one dtype,
    the product rounded to it, then the bias added in it. ``weight`` is
    nn.Linear's (out, in). Below f32 the bias is a separate add:
    ``F.linear`` with a bias adds it inside the product and rounds once,
    which in bf16 differs by a rounding step. In f32 and wider the product
    is already in the working dtype, so the fused bias rounds the same."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is None or not narrow(dt):
        return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))
    return F.linear(x.to(dt), weight.to(dt)) + bias.to(dt)


def tf32_route(x: torch.Tensor, weight: torch.Tensor, attached: bool = False) -> bool:
    """Whether a dense layer of ``weight`` (out, in) on ``x`` takes the
    split-TF32 kernel (``kernels.dense_tf32``), whose f32 result differs
    from ``dense_apply``'s by f32 rounding: when x lies on a CUDA device, x
    and the weight promote to f32, grad mode is off (as under
    ``torch.inference_mode``, where the service and the exported programs
    run), no model axis is attached (``attached``: the module's ``tp`` or
    ``seq``), and the depth is a multiple of 8 with both operands
    contiguous and 16-byte aligned. Everything else (the CPU, bf16,
    training with autograd, the model axes) takes ``dense_apply``."""
    k = weight.shape[-1]
    return (x.is_cuda and not attached and not torch.is_grad_enabled()
            and torch.promote_types(x.dtype, weight.dtype) == torch.float32
            and weight.dim() == 2 and x.shape[-1] == k and k % 8 == 0
            and x.is_contiguous() and weight.is_contiguous()
            and x.data_ptr() % 16 == 0 and weight.data_ptr() % 16 == 0)
