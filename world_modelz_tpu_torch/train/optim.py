"""Optimizer construction and the global gradient norm.

Port of ``world_modelz_tpu.train.optim``: ``"adamw"`` is
``torch.optim.AdamW`` and ``"adam"`` ``torch.optim.Adam`` (eps 1e-8, as
optax), with the learning rate set from a schedule before every update.

optax evaluates a schedule at the update count *before* incrementing it,
so with a warmup the first update runs at lr = schedule(0) = 0 while the
moments still move; ``ScheduledOptimizer`` does the same. torch's AdamW
decays the weights by lr * wd before the Adam update, which is optax's
``add_decayed_weights`` on the same (pre-update) parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Union

import torch

LearningRate = Union[float, Callable[[int], float]]


class ScheduledOptimizer:
    """A torch optimizer plus its schedule and update count.

    ``step()`` sets every group's lr to ``schedule(count)``, applies the
    update, and counts it. A step that is not taken (a rejected update)
    leaves the count, so the schedule, where it was, as optax's rejected
    ``opt_state`` does.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: LearningRate):
        self.optimizer = optimizer
        self.schedule = schedule if callable(schedule) else (lambda _: schedule)
        self.count = 0

    def step(self) -> None:
        lr = float(self.schedule(self.count))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, sd: Dict) -> None:
        self.optimizer.load_state_dict(sd["optimizer"])
        self.count = int(sd["count"])


def make_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    learning_rate: LearningRate,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
) -> ScheduledOptimizer:
    name = name.lower()
    params = list(params)
    # foreach: one launch per op for the whole parameter list on CUDA
    if name == "adamw":
        opt = torch.optim.AdamW(
            params, lr=0.0, betas=(b1, b2), eps=1e-8,
            weight_decay=weight_decay, foreach=True,
        )
    elif name == "adam":
        opt = torch.optim.Adam(
            params, lr=0.0, betas=(b1, b2), eps=1e-8, foreach=True)
    else:
        raise ValueError(f"Unsupported optimizer: {name!r}")
    return ScheduledOptimizer(opt, learning_rate)


@torch.no_grad()
def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all gradients (main2.py:200-205), on the device: a
    float32 scalar tensor."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))
