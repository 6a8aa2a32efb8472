"""Learning-rate schedule as a plain function of the step.

Port of ``world_modelz_tpu.train.schedules.warmup_cosine_schedule`` with
optax semantics: a linear ramp 0 -> lr over ``warmup_steps`` (optax
``linear_schedule``), then ``cosine_decay_schedule(lr, total_steps)``
evaluated at ``step - warmup_steps`` (``join_schedules``). The reference's
CosineAnnealingLR keeps its own step counter that starts when the warmup
ends (warmup_scheduler.py:59-61). The function is host code, so the JAX
package's ``host_schedule`` has no counterpart.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _cosine(base_lr: float, total_steps: int, step: int) -> float:
    """optax.cosine_decay_schedule(base_lr, total_steps) with alpha 0."""
    frac = min(max(step, 0), total_steps) / total_steps
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))


def warmup_cosine_schedule(
    base_lr: float, warmup_steps: int, total_steps: int
) -> Schedule:
    """lr ramps 0 -> base_lr over ``warmup_steps``, then cosine-anneals to 0
    over ``total_steps`` of its own."""
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")

    def schedule(step: int) -> float:
        if warmup_steps <= 0:
            return _cosine(base_lr, total_steps, step)
        if step < warmup_steps:
            return base_lr * max(step, 0) / warmup_steps
        return _cosine(base_lr, total_steps, step - warmup_steps)

    return schedule
