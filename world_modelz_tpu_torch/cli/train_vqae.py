"""VQ-VAE tokenizer training CLI.

Port of ``world_modelz_tpu.cli.train_vqae`` (reference:
minecraft/train_vqae.py:170-316): reconstruction loss (MAE/L1, MSE or
SmoothL1) + ``latent_loss_weight`` x the commitment loss, the global
gradient norm, AdamW under the step-decay schedule, the EMA codebook
update inside the tokenizer's forward, periodic dead-code revival
(``vq_reuse_interval``), checkpoints with the config embedded, PNG grids
of the reconstructions, JSONL metrics, resume and the non-finite guard.

On the GPU the quantizer's search and per-code statistics run the
hand-written kernel ``vq_train_stats`` (``csrc/vq_train.cu``) for both
``--vq_backend`` values: ``"xla"`` and ``"pallas"`` are accepted so that
checkpoint configs match the JAX package's. On the CPU ``"xla"`` runs the
plain ``vq_apply`` and ``"pallas"`` the plain statistics of
``vq_apply_fused``, as the JAX backends do.

The step reads (loss, grad norm, ok, ...) on the host once. A rejected
step (non-finite loss or grad norm, with the guard on) skips the
optimizer and copies back the buffers the forward updated in place
(BatchNorm running statistics and the VQ state), so params, optimizer
state, BatchNorm statistics and the VQ state stay bitwise as they were,
as the JAX package's on-device select leaves them.

Checkpoints hold ``tokenizer`` (the state_dict in the reference layout,
which ``load_tokenizer`` and so ``cli.video_diffusion --decoder_model``
read), ``vq_stats`` (the VQ activation and error statistics) and
``opt_state``.

``--wandb`` (with its ``--project`` and ``--tags``) logs to the JSONL file
only without the wandb package, as the JAX logger does.

The data: ``--dataset synthetic`` (procedural trajectory frames),
``moving_mnist`` or ``files`` (the images under ``--image_dir_path`` whose
paths match ``--image_fn_regex``, listed once in ``--file_list_fn`` and
decoded by PIL); with ``--data_pipeline grain`` MovingMNIST or the files
stream through Grain (``data_workers`` processes) and every checkpoint keeps
the consumed position (``grain_state.json``) that ``--checkpoint`` restores.

Data parallelism: launched by ``torchrun`` (one process a GPU, or CPU
processes under gloo with ``--platform cpu``) the trainer splits the global
``--batch_size`` over the processes; each draws its rows from a source
seeded by (seed, rank), the gradients are averaged over the ranks, and the
global batch's statistics are taken across them: BatchNorm's moments (two
passes) and the quantizer's per-code counts, errors and input sums, summed
before the EMA update (the ``vq_train_stats`` kernel stays on the path).
Rank 0 alone writes checkpoints, logs and images; every rank reads a
resume checkpoint. ``--n_model`` splits the world into data x model (JAX's
layout): no rule matches a conv tokenizer, so the model axis only
replicates its work, the model ranks of one data coordinate drawing the
same rows, and the batch and its statistics shard over ``data`` alone, as
in JAX.

Run (the GPU by default, ``--platform cpu`` for the CPU):

    python -m world_modelz_tpu_torch.cli.train_vqae --dataset moving_mnist \\
        --in_channels 1 --output_dir outputs/vqae
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from world_modelz_tpu_torch._device import DeviceLike, platform_device
from world_modelz_tpu_torch.data import (
    FileListImageDataset,
    MovingMNIST,
    PrefetchIterator,
    SyntheticTrajectorySource,
    load_file_list,
)
from world_modelz_tpu_torch.models import VQAutoEncoder
from world_modelz_tpu_torch.ops.vq import vq_reset_stats, vq_reuse_inactive
from world_modelz_tpu_torch.parallel.distributed import (
    all_reduce_mean,
    initialize_distributed,
    process_device,
    rank_seed,
)
from world_modelz_tpu_torch.parallel.mesh import Mesh, attach, check_batch, make_mesh
from world_modelz_tpu_torch.train import (
    AsyncCheckpointSaver,
    CheckpointGuard,
    ScheduledOptimizer,
    global_grad_norm,
    host_schedule,
    latest_checkpoint,
    make_optimizer,
    pipeline_files,
    restore_checkpoint,
    restore_pipeline,
    save_checkpoint,
    step_decay_schedule,
)
from world_modelz_tpu_torch.utils import save_image
from world_modelz_tpu_torch.utils.logging import rank_logger
from world_modelz_tpu_torch.utils.config import (
    config_from_dict,
    config_to_dict,
    dataclass_cli,
)


@dataclasses.dataclass
class TrainVqaeConfig:
    """Flags mirror minecraft/train_vqae.py:70-102 (field names and
    defaults of the JAX package's config)."""

    manual_seed: int = 0
    platform: str = ""  # "" = the GPU (raises without one), "cpu"
    batch_size: int = 96
    optimizer: str = "AdamW"
    weight_decay: float = 1e-4
    lr: float = 2e-4
    loss_fn: str = "MAE"  # MAE|L1|MSE|SmoothL1
    nan_guard: bool = True  # reject non-finite steps; restore on streaks
    max_steps: int = 10000
    lr_decay_interval: int = 3000  # halve the lr every this many steps

    # "xla" | "pallas": on the GPU both run the vq_train_stats kernel; on
    # the CPU they pick the plain quantizer as the JAX backends do
    vq_backend: str = "xla"

    downscale_steps: int = 3
    embedding_dim: int = 64
    hidden_planes: int = 128
    num_embeddings: int = 512
    in_channels: int = 3

    dataset: str = "synthetic"  # synthetic|moving_mnist|files
    # "native" = the in-repo sources; "grain" = the deterministic,
    # checkpointable Grain stream (moving_mnist and files)
    data_pipeline: str = "native"
    data_workers: int = 0  # grain worker processes (0 = in-process)
    image_size: int = 64
    file_list_fn: str = "file_list.json"  # the files dataset's cached list
    image_dir_path: str = ""  # the files dataset's (recursive) glob
    image_fn_regex: str = r".*\.png$"  # the files dataset's path filter

    checkpoint_interval: int = 2500
    latent_loss_weight: float = 0.005
    vq_reuse_interval: int = 500
    log_interval: int = 50

    n_model: int = 1  # model axis (the tokenizer is conv: it replicates)
    wandb: bool = False  # without the wandb package: JSONL only
    project: str = "mcvq"  # wandb project
    tags: str = ""  # wandb tags, comma-separated
    name: str = "vqae"
    output_dir: str = "outputs/vqae"
    checkpoint: str = ""  # resume path


def check_supported(cfg: TrainVqaeConfig) -> None:
    """Raise for options of features not ported (NotImplementedError) and
    for values the JAX CLI refuses too (ValueError)."""
    if cfg.dataset not in ("moving_mnist", "synthetic", "files"):
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    if cfg.data_pipeline not in ("native", "grain"):
        raise ValueError(f"unknown data_pipeline {cfg.data_pipeline!r}")
    if cfg.data_pipeline == "grain" and cfg.dataset == "synthetic":
        raise ValueError(
            f"--data_pipeline grain is not supported for dataset "
            f"{cfg.dataset!r} (random-access sources only)")
    if cfg.n_model < 1:
        raise ValueError(f"--n_model must be >= 1, got {cfg.n_model}")
    if cfg.vq_backend not in ("xla", "pallas"):
        raise ValueError(
            f"--vq_backend must be 'xla' or 'pallas', got {cfg.vq_backend!r}")
    _loss_fn(cfg.loss_fn)


def build_batch_fn(cfg: TrainVqaeConfig, seed: int) -> Tuple[Callable[[], np.ndarray], Any]:
    """Host batch source (JAX ``build_batch_fn``) -> ((() -> (B, H, W, C)
    float32 in [0, 1]), the Grain pipeline or None)."""
    check_supported(cfg)
    rng = np.random.default_rng(seed)
    if cfg.data_pipeline == "grain":
        from world_modelz_tpu_torch.data.grain_pipeline import GrainClipPipeline

        if cfg.dataset == "moving_mnist":
            ds = MovingMNIST(seq_len=1, image_size=cfg.image_size, digit_size=24,
                             num_digits=2)
            pipe = GrainClipPipeline(ds, cfg.batch_size, seed=seed,
                                     worker_count=cfg.data_workers)
            return (lambda: pipe.sample_batch()[:, 0]), pipe
        files = load_file_list(cfg.file_list_fn, cfg.image_dir_path, cfg.image_fn_regex)
        pipe = GrainClipPipeline(FileListImageDataset(files, cfg.batch_size, seed=seed),
                                 cfg.batch_size, seed=seed, worker_count=cfg.data_workers)
        return pipe.sample_batch, pipe
    if cfg.dataset == "files":
        files = load_file_list(cfg.file_list_fn, cfg.image_dir_path, cfg.image_fn_regex)
        return FileListImageDataset(files, cfg.batch_size, seed=seed).next_batch, None
    if cfg.dataset == "moving_mnist":
        if cfg.in_channels != 1:
            raise ValueError(
                "--dataset moving_mnist produces 1-channel frames; pass "
                f"--in_channels 1 (got {cfg.in_channels})"
            )
        ds = MovingMNIST(
            seq_len=1, image_size=cfg.image_size, digit_size=24, num_digits=2
        )
        return lambda: ds.sample_batch(rng, cfg.batch_size)[:, 0], None
    if cfg.in_channels != 3:
        raise ValueError(
            "--dataset synthetic produces 3-channel (RGB) frames; pass "
            f"--in_channels 3 (got {cfg.in_channels})"
        )
    src = SyntheticTrajectorySource(
        num_trajectories=32, traj_frames=64, frame_size=cfg.image_size,
        seed=seed,
    )
    frames = np.concatenate(
        [np.stack(list(src.load_frames(n))) for n in src.trajectory_names()]
    ).astype(np.float32) / 255.0

    def sample():
        idx = rng.integers(0, len(frames), cfg.batch_size)
        return frames[idx]

    return sample, None


def make_tokenizer(cfg: TrainVqaeConfig, device: DeviceLike = None) -> VQAutoEncoder:
    return VQAutoEncoder(
        embedding_dim=cfg.embedding_dim,
        num_embeddings=cfg.num_embeddings,
        downscale_steps=cfg.downscale_steps,
        hidden_planes=cfg.hidden_planes,
        in_channels=cfg.in_channels,
        vq_backend=cfg.vq_backend,
        device=device,
    )


def load_tokenizer(path: str, device: DeviceLike = None) -> Tuple[VQAutoEncoder, Dict]:
    """Rehydrate a tokenizer from a checkpoint's embedded config (the
    reference's decoder_model contract, main2.py:390-396): a checkpoint of
    this trainer, or a JAX tokenizer written by
    ``convert.tokenizer_checkpoint_from_state``. Returns (tokenizer in
    eval mode with its VQ statistics, config)."""
    state, _step, config = restore_checkpoint(path)
    tok = make_tokenizer(config_from_dict(TrainVqaeConfig, config), device)
    tok.load_state_dict(state["tokenizer"], strict=True)
    if "vq_stats" in state:
        tok.vq.load_stats(state["vq_stats"])
    return tok, config


def _loss_fn(kind: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    kind = kind.lower()
    if kind in ("mae", "l1"):
        return F.l1_loss
    if kind == "mse":
        return F.mse_loss
    if kind == "smoothl1":  # optax.huber_loss with delta 1
        return lambda a, b: F.huber_loss(a, b, delta=1.0)
    raise ValueError(f"unsupported loss {kind!r}")


@dataclasses.dataclass
class TrainState:
    """Everything a step updates. ``step`` counts steps taken, rejected
    ones included (the checkpoint's step); the optimizer counts the
    updates it applied (the schedule's step)."""

    tok: VQAutoEncoder
    optimizer: ScheduledOptimizer
    step: int = 0
    # the buffers the forward updates in place, and their copies from
    # before the current step (the guard's restore point)
    buffers: List[torch.Tensor] = dataclasses.field(default_factory=list)
    saved: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def state_dict(self) -> Dict:
        return {
            "tokenizer": self.tok.state_dict(),
            "vq_stats": self.tok.vq.stats(),
            "opt_state": self.optimizer.state_dict(),
        }

    @torch.no_grad()
    def load_state_dict(self, sd: Dict, step: int) -> None:
        """Restore a checkpoint; one without ``opt_state`` (a converted
        JAX tokenizer) keeps the fresh optimizer, one without
        ``vq_stats`` zeroes the statistics."""
        self.tok.load_state_dict(sd["tokenizer"], strict=True)
        stats = sd.get("vq_stats")
        if stats is None:
            stats = {k: torch.zeros_like(v) for k, v in self.tok.vq.stats().items()}
        self.tok.vq.load_stats(stats)
        if "opt_state" in sd:
            self.optimizer.load_state_dict(sd["opt_state"])
        self.step = step


def init_state(cfg: TrainVqaeConfig, tok: VQAutoEncoder,
               mesh: Optional[Mesh] = None) -> TrainState:
    """A fresh state for ``tok`` on the data axis of ``mesh`` (None: one
    process), whose batch statistics then cross the mesh."""
    schedule = step_decay_schedule(
        cfg.lr, steps_per_epoch=cfg.lr_decay_interval, epoch_step_size=1)
    attach(tok, mesh or Mesh())
    opt = make_optimizer(cfg.optimizer, tok.parameters(), schedule, cfg.weight_decay,
                         mesh=mesh)
    buffers = list(tok.buffers())
    return TrainState(tok, opt, 0, buffers, [b.clone() for b in buffers])


def train_step(
    state: TrainState, batch: torch.Tensor, cfg: TrainVqaeConfig
) -> Tuple[Dict[str, float], bool, torch.Tensor]:
    """One optimizer step (JAX ``train_step``, cli/train_vqae.py:279-312)
    on a (B, H, W, C) float batch; updates ``state`` in place and returns
    (metrics read on the host, ok, the reconstruction)."""
    tok = state.tok
    torch._foreach_copy_(state.saved, state.buffers)
    state.optimizer.zero_grad()
    recon, out = tok(batch, train=True)
    r_loss = _loss_fn(cfg.loss_fn)(recon, batch)
    total = r_loss + cfg.latent_loss_weight * out.commitment_loss
    total.backward()
    opt = state.optimizer
    g = opt.reduced_grad()  # the global batch's (averaged over the data axis)
    gn = global_grad_norm(opt.views(g))
    losses = all_reduce_mean(torch.stack([
        total.detach(), r_loss.detach(), out.commitment_loss.detach()]), opt.mesh)
    ok = torch.isfinite(losses[0]) & torch.isfinite(gn)
    # the step's one host read: the guard decides on the host
    vals = torch.cat([losses, torch.stack([out.perplexity, gn, ok.to(torch.float32)])]).tolist()
    metrics = dict(zip(
        ("loss", "r_loss", "latent_loss", "perplexity", "grad_norm"), vals))
    ok_v = vals[-1] > 0.5
    if ok_v or not cfg.nan_guard:
        opt.assign(opt.propose(g))
    else:  # undo the forward's in-place updates
        torch._foreach_copy_(state.buffers, state.saved)
    state.step += 1
    return metrics, ok_v, recon.detach()


@torch.no_grad()
def reuse_step(tok: VQAutoEncoder) -> torch.Tensor:
    """Dead-code revival, then zeroed statistics; returns the number of
    reused codes (a tensor on the tokenizer's device)."""
    vq, count = vq_reuse_inactive(tok.vq.state())
    tok.vq.load_state(vq_reset_stats(vq))
    return count


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    # per step: the step's metrics, "step", "ok" and "t" (host clock after
    # the step)
    history: List[Dict[str, float]]
    rejected: int
    checkpoint: str  # the final checkpoint
    metrics_path: str  # the JSONL log


def train(cfg: TrainVqaeConfig) -> TrainResult:
    """Train as the JAX ``train`` does; returns the final state, each
    step's metrics and the final checkpoint's path."""
    check_supported(cfg)
    device = platform_device(cfg.platform)
    initialize_distributed(device=device)
    device = process_device(device)
    mesh = make_mesh(n_model=cfg.n_model)
    local_cfg = dataclasses.replace(cfg, batch_size=check_batch(cfg.batch_size, mesh))
    lead = mesh.lead
    torch.manual_seed(cfg.manual_seed)
    tok = make_tokenizer(cfg, device)
    grid = tok.downscale_steps
    print("latent grid:", (cfg.image_size // 2**grid, cfg.image_size // 2**grid),
          "params:", sum(p.numel() for p in tok.parameters()))
    state = init_state(cfg, tok, mesh)
    lr_of = host_schedule(state.optimizer.schedule)
    if cfg.checkpoint:
        restored, at_step, _ = restore_checkpoint(cfg.checkpoint)
        state.load_state_dict(restored, at_step)
        print(f"resumed from {cfg.checkpoint} at step {at_step}")
    start_step = state.step
    config = config_to_dict(cfg)

    batch_fn, pipeline = build_batch_fn(local_cfg, rank_seed(cfg.manual_seed, mesh.rank))
    if cfg.checkpoint:
        restore_pipeline(pipeline, cfg.checkpoint)
    # a Grain position rides the queue with its batch: a checkpoint records
    # the position consumed, not the one prefetched ahead
    batches = PrefetchIterator(batch_fn, depth=2, device=device,
                               state_fn=getattr(pipeline, "get_state", None))
    logger = rank_logger(mesh.process, cfg.output_dir, cfg.name, use_wandb=cfg.wandb,
                         project=cfg.project, config=config_to_dict(cfg), tags=cfg.tags)
    saver = AsyncCheckpointSaver()

    def restore_latest():
        """Reload the newest on-disk checkpoint (guard escalation)."""
        saver.wait()  # an in-flight save must land first
        mesh.barrier()  # rank 0's
        path = latest_checkpoint(cfg.output_dir) or cfg.checkpoint
        if not path:
            return None
        restored, at_step, _ = restore_checkpoint(path)
        state.load_state_dict(restored, at_step)
        print(f"[guard] restored {path} (step {at_step})")
        return path

    # the port reads every step's ok flag, so the guard counts steps (the
    # JAX trainer samples the flag at log points)
    guard = CheckpointGuard(restore_latest)
    history: List[Dict[str, float]] = []
    rejected = 0
    t0 = time.time()
    try:
        for step in range(start_step + 1, cfg.max_steps + 1):
            batch = next(batches)
            metrics, ok, recon = train_step(state, batch, cfg)
            history.append(dict(metrics, step=step, ok=ok, t=time.perf_counter()))
            accepted = ok or not cfg.nan_guard
            if not accepted:
                rejected += 1
                print(f"{step}: step REJECTED (non-finite loss/grads)")
            guard.record(accepted, step)

            if cfg.vq_reuse_interval and step % cfg.vq_reuse_interval == 0:
                metrics["reused"] = reuse_step(tok)

            if step % cfg.log_interval == 0 or step == start_step + 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["lr"] = lr_of(step)
                m["steps_per_sec"] = cfg.log_interval / max(time.time() - t0, 1e-9)
                t0 = time.time()
                logger.log(step, **m)
                print(f"step {step}: loss {m['loss']:.4f} "
                      f"perplexity {m['perplexity']:.1f} lr {m['lr']:.2e}")

            if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0 and lead:
                path = saver.save(cfg.output_dir, step, state.state_dict(), config,
                                  pipeline_files(batches.consumed_state()))
                print("checkpoint:", path)
                save_image(
                    recon[:16].float().cpu().numpy(),
                    os.path.join(cfg.output_dir,
                                 f"{cfg.name}_reconst_{step:07d}.png"))
    finally:
        try:
            saver.wait()  # the last async save must land before exit
        finally:
            batches.close()
            logger.close()
            if pipeline is not None:
                pipeline.close()

    final = os.path.join(os.path.abspath(cfg.output_dir), f"step_{cfg.max_steps:07d}")
    if lead:
        final = save_checkpoint(cfg.output_dir, cfg.max_steps, state.state_dict(), config,
                                pipeline_files(batches.consumed_state()))
        print("final checkpoint:", final)
    mesh.barrier()  # the final checkpoint is there for every rank
    return TrainResult(state, history, rejected, final, logger.path)


def main(argv: Optional[List[str]] = None):
    cfg = dataclass_cli(TrainVqaeConfig, argv)
    print("Config:", cfg)
    train(cfg)


if __name__ == "__main__":
    main()
