"""Training failure detection and recovery.

Port of ``world_modelz_tpu.train.guard``. ``tree_all_finite`` and
``reject_nonfinite`` are the tensor halves; ``CheckpointGuard`` and
``RestartManager`` are host code, copied as they are: after
``max_rejects`` consecutive rejected steps the guard calls its restore
callback (reload the last good checkpoint).

The diffusion trainers select on the device with ``reject_nonfinite``
inside their step (``cli/video_diffusion.py:ce_step``), as JAX's
``step_body`` does, and hand each step's ``ok`` flag to the guard after
the dispatch's one host read; the tokenizer trainer decides on the host.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch


def tree_all_finite(tree: Any) -> torch.Tensor:
    """Bool scalar tensor: every floating tensor in ``tree`` (a tensor, or
    nested dicts / lists / tuples of them) is finite."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                leaves.append(torch.isfinite(x).all())
        elif isinstance(x, Mapping):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([leaf.to(leaves[0].device) for leaf in leaves]).all()


def reject_nonfinite(ok: torch.Tensor, old: Any, new: Any) -> Any:
    """Keep every tensor of ``old`` where the scalar ``ok`` is False, else
    take ``new``; ``old`` and ``new`` share one nested structure."""
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if isinstance(new, Mapping):
        return {k: reject_nonfinite(ok, old[k], v) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        return type(new)(reject_nonfinite(ok, o, n) for o, n in zip(old, new))
    return new


class CheckpointGuard:
    """Host-side wiring of :class:`RestartManager` to a restore callback:
    after ``max_rejects`` consecutive rejected steps, ``restore_fn()`` is
    called and its result returned, so the loop can swap in the restored
    state; otherwise ``record`` returns None."""

    def __init__(self, restore_fn, max_rejects: int = 5):
        self.manager = RestartManager(max_rejects)
        self.restore_fn = restore_fn

    def record(self, accepted: bool, step: int = -1):
        self.manager.record(bool(accepted))
        if self.manager.should_restore():
            print(
                f"[guard] {self.manager.max_rejects} consecutive rejected "
                f"sync points at step {step}; restoring last checkpoint"
            )
            return self.restore_fn()
        return None


class RestartManager:
    """Escalate from step rejection to checkpoint restore.

    Args:
      max_rejects: consecutive rejected steps tolerated before
        ``should_restore()`` turns True (then counters reset).
    """

    def __init__(self, max_rejects: int = 10):
        self.max_rejects = max_rejects
        self.consecutive_rejects = 0
        self.total_rejects = 0
        self.restores = 0

    def record(self, accepted: bool) -> None:
        if accepted:
            self.consecutive_rejects = 0
        else:
            self.consecutive_rejects += 1
            self.total_rejects += 1

    def should_restore(self) -> bool:
        if self.consecutive_rejects >= self.max_rejects:
            self.consecutive_rejects = 0
            self.restores += 1
            return True
        return False

