"""Training utilities: optimizer, schedule, EMA, importance sampling, the
non-finite guard and checkpoints."""

from world_modelz_tpu_torch.train.checkpoint import (
    AsyncCheckpointSaver,
    latest_checkpoint,
    pipeline_files,
    restore_checkpoint,
    restore_pipeline,
    save_checkpoint,
)
from world_modelz_tpu_torch.train.ema import ema_init, ema_update
from world_modelz_tpu_torch.train.guard import (
    CheckpointGuard,
    RestartManager,
    reject_nonfinite,
    tree_all_finite,
)
from world_modelz_tpu_torch.train.importance import (
    LossAwareSamplerState,
    loss_aware_init,
    loss_aware_sample,
    loss_aware_update,
    loss_aware_warmed_up,
    loss_aware_weights,
    uniform_sample,
)
from world_modelz_tpu_torch.train.optim import (
    ScheduledOptimizer,
    global_grad_norm,
    make_optimizer,
)
from world_modelz_tpu_torch.train.schedules import (
    host_schedule,
    step_decay_schedule,
    warmup_cosine_schedule,
)

__all__ = [
    "warmup_cosine_schedule",
    "step_decay_schedule",
    "host_schedule",
    "ema_init",
    "ema_update",
    "LossAwareSamplerState",
    "loss_aware_init",
    "loss_aware_sample",
    "loss_aware_update",
    "loss_aware_warmed_up",
    "loss_aware_weights",
    "uniform_sample",
    "make_optimizer",
    "ScheduledOptimizer",
    "global_grad_norm",
    "CheckpointGuard",
    "RestartManager",
    "reject_nonfinite",
    "tree_all_finite",
    "save_checkpoint",
    "latest_checkpoint",
    "pipeline_files",
    "restore_pipeline",
    "restore_checkpoint",
    "AsyncCheckpointSaver",
]
