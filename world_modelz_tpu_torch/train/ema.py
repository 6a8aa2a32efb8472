"""Shadow-weights exponential moving average over a parameter dict.

Port of ``world_modelz_tpu.train.ema`` (reference: minecraft/
model_ema_v2.py:8-47): the EMA is a second dict of tensors beside the
parameters, updated in place with ``torch._foreach_*`` (one launch per op
for the whole dict on CUDA).
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


@torch.no_grad()
def ema_init(params: Params) -> Params:
    """Start the shadow copy at the current values (model_ema_v2.py:29),
    in distinct buffers."""
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema: Params, params: Params, decay: float) -> Params:
    """ema = decay * ema + (1 - decay) * params (model_ema_v2.py:44), in
    place; returns ``ema``."""
    keys = list(ema)
    shadow = [ema[k] for k in keys]
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(
        shadow, torch._foreach_mul([params[k].detach() for k in keys], 1.0 - decay)
    )
    return ema
