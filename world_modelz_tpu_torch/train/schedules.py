"""Learning-rate schedules as plain functions of the step.

Port of ``world_modelz_tpu.train.schedules`` with optax semantics:

- ``warmup_cosine_schedule``: a linear ramp 0 -> lr over ``warmup_steps``
  (optax ``linear_schedule``), then ``cosine_decay_schedule(lr,
  total_steps)`` evaluated at ``step - warmup_steps`` (``join_schedules``).
  The reference's CosineAnnealingLR keeps its own step counter that starts
  when the warmup ends (warmup_scheduler.py:59-61).
- ``step_decay_schedule``: optax ``exponential_decay(staircase=True)``,
  the reference's StepLR (train_vqae.py:304).

The functions are host code; ``host_schedule`` is the JAX package's
log-point reader, kept so the trainers read the lr the same way.
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


def step_decay_schedule(
    base_lr: float, steps_per_epoch: int, epoch_step_size: int = 3,
    gamma: float = 0.5,
) -> Schedule:
    """lr * gamma ** floor(step / (epoch_step_size * steps_per_epoch)): the
    lr is multiplied by ``gamma`` every ``epoch_step_size`` epochs."""
    period = epoch_step_size * steps_per_epoch
    if period <= 0:
        raise ValueError(
            f"epoch_step_size * steps_per_epoch must be positive, got {period}")

    def schedule(step: int) -> float:
        return base_lr * gamma ** (max(step, 0) // period)

    return schedule


def host_schedule(schedule: Schedule) -> Callable[[int], float]:
    """The lr at a step as a Python float, for log lines."""
    return lambda step: float(schedule(int(step)))
