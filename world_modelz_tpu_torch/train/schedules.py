"""Learning-rate schedules as plain functions of the step.

Port of ``world_modelz_tpu.train.schedules`` with optax semantics:

- ``warmup_cosine_schedule``: a linear ramp 0 -> lr over ``warmup_steps``
  (optax ``linear_schedule``), then ``cosine_decay_schedule(lr,
  total_steps)`` evaluated at ``step - warmup_steps`` (``join_schedules``).
  The reference's CosineAnnealingLR keeps its own step counter that starts
  when the warmup ends (warmup_scheduler.py:59-61).
- ``step_decay_schedule``: optax ``exponential_decay(staircase=True)``,
  the reference's StepLR (train_vqae.py:304).

A schedule called with a Python int is host code and returns a float
(``host_schedule`` is the JAX package's log-point reader, kept so the
trainers read the lr the same way). Called with a tensor (the optimizer's
update count on the device) it returns a 0-d float32 tensor computed as
optax computes it in float32, so a captured train step reads its lr from
the device and no host value is baked into the graph.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

Step = Union[int, torch.Tensor]
Schedule = Callable[[Step], Union[float, torch.Tensor]]


def _cosine_t(base_lr: float, total_steps: int, step: torch.Tensor) -> torch.Tensor:
    """optax.cosine_decay_schedule(base_lr, total_steps)(step) in float32."""
    count = torch.clamp(step.to(torch.float32), max=float(total_steps))
    decay = 0.5 * (1.0 + torch.cos(math.pi * count / float(total_steps)))
    return base_lr * decay


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

    def schedule(step: Step):
        if isinstance(step, torch.Tensor):
            if warmup_steps <= 0:
                return _cosine_t(base_lr, total_steps, step)
            # optax.join_schedules of linear_schedule(0, base_lr, warmup)
            # and the cosine, at the boundary ``warmup_steps``
            count = torch.clamp(step.to(torch.float32), 0.0, float(warmup_steps))
            frac = 1.0 - count / float(warmup_steps)
            ramp = (0.0 - base_lr) * frac + base_lr
            return torch.where(step < warmup_steps, ramp,
                               _cosine_t(base_lr, total_steps, step - warmup_steps))
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

    def schedule(step: Step):
        if isinstance(step, torch.Tensor):
            # optax.exponential_decay(staircase=True) in float32
            p = torch.floor(step.to(torch.float32) / float(period))
            return torch.where(step <= 0, base_lr, base_lr * torch.pow(gamma, p))
        return base_lr * gamma ** (max(step, 0) // period)

    return schedule


def host_schedule(schedule: Schedule) -> Callable[[int], float]:
    """The lr at a step as a Python float, for log lines."""
    return lambda step: float(schedule(int(step)))
