"""Masked video-diffusion training CLI (next-frame prediction).

Port of ``world_modelz_tpu.cli.video_diffusion`` (reference:
vq-video-diffusion/main.py, minecraft/main2.py), training half:
- frozen VQ tokenizer loaded from a checkpoint's embedded config
  (main2.py:390-396; ``cli.train_vqae.load_tokenizer``, so the tokenizer
  trainer's checkpoints feed it), encoded through the ``vq_encode`` kernel
- loss-aware diffusion-time sampling and masked corruption of the last
  frame (main2.py:251-264)
- the local-3D-attention denoiser, whose attention runs the forward kernel
  and the split backward pair; cross-entropy on the last frame
  (main2.py:271-279)
- warmup + cosine AdamW, optional EMA of the weights, the non-finite guard
- checkpoints that bundle params / EMA / optimizer / sampler and the config
  (main2.py:302-314), resume and warm start

With ``bf16`` the f32 master weights are cast to a bf16 copy for the
forward (``torch.func.functional_call``); the cast is differentiable, so
the gradients land in f32 on the masters, as JAX's cast in ``loss_fn``.

The step reads its (loss, grad norm, ok) on the host once: a rejected step
(non-finite loss or grad norm) then skips the sampler update, the optimizer
and the EMA, which leaves the whole state bitwise unchanged, as the JAX
package's on-device select does.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP item
that ports them: evaluation (``--eval``, ``eval_interval``), other
datasets, the grain pipeline and device compositing, parallelism,
gradient accumulation, fused dispatch, the timing report and wandb. The
flags of those features that are kept only for parity with the JAX CLI
raise at any value other than their default.

Run (the GPU by default, ``--platform cpu`` for the CPU):

    python -m world_modelz_tpu_torch.cli.video_diffusion \\
        --decoder_model <tokenizer checkpoint> --eval_interval 0
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from world_modelz_tpu_torch._device import platform_device
from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer
from world_modelz_tpu_torch.data import MovingMNIST, PrefetchIterator
from world_modelz_tpu_torch.diffusion import corrupt_tokens
from world_modelz_tpu_torch.models import (
    VQAutoEncoder,
    VqVideoDiffusionModel,
    tokenizer_inference_cast,
)
from world_modelz_tpu_torch.train import (
    AsyncCheckpointSaver,
    CheckpointGuard,
    LossAwareSamplerState,
    ScheduledOptimizer,
    ema_init,
    ema_update,
    global_grad_norm,
    latest_checkpoint,
    loss_aware_init,
    loss_aware_sample,
    loss_aware_update,
    make_optimizer,
    restore_checkpoint,
    warmup_cosine_schedule,
)
from world_modelz_tpu_torch.utils.config import (
    check_defaults,
    config_to_dict,
    dataclass_cli,
    unported,
)


@dataclasses.dataclass
class VideoDiffusionConfig:
    """Flags mirror minecraft/main2.py:149-197 (field names and defaults
    of the JAX package's config)."""

    manual_seed: int = 42
    platform: str = ""  # "" = the GPU (raises without one), "cpu"
    lr: float = 1e-4
    batch_size: int = 10
    optimizer: str = "AdamW"
    weight_decay: float = 1e-7
    ema_decay: float = 0.0
    bf16: bool = False  # bfloat16 compute with f32 master weights
    nan_guard: bool = True  # reject steps with non-finite loss/grads

    dataset: str = "moving_mnist"  # only moving_mnist is ported
    device_composite: bool = False  # not ported
    data_pipeline: str = "native"  # "grain" is not ported
    data_workers: int = 0  # grain worker processes: not ported
    data_dir: str = ""
    image_size: int = 64
    n_past: int = 5
    num_digits: int = 2
    digit_size: int = 24
    decoder_model: str = ""  # tokenizer checkpoint path (required)
    # run the frozen tokenizer with bf16-rounded conv weights (the codebook
    # stays f32), as the JAX trainer's default
    tok_bf16: bool = True

    max_steps: int = 200_000
    warmup: int = 500
    accumulation_steps: int = 1  # > 1 not ported
    steps_per_dispatch: int = 1  # > 1 not ported
    checkpoint_interval: int = 25_000
    eval_interval: int = 2000  # evaluation is not ported: 0 to train
    eval_timesteps: int = 4  # evaluation: not ported
    eval_batch_size: int = 8  # evaluation: not ported
    num_eval_iterations: int = 30  # evaluation: not ported
    p_max_uniform: float = 0.1
    log_interval: int = 10
    # "deferred" or "sync": the port reads each step's stats on the host,
    # so both modes log the step's own values (JAX's "sync" behaviour)
    log_fence: str = "deferred"
    # sampler-weight histograms go to the metric logger: not ported
    histogram_interval: int = 50
    timing_report: str = ""  # not ported
    probe_interval: int = 200  # timing-report probes: not ported

    dim: int = 256
    extents: Tuple[int, int, int] = (3, 3, 3)
    depth: int = 4
    mlp_dim: int = 256
    dim_head: int = 128
    heads: int = 1
    dropout: float = 0.0

    buffer_size: int = 100_000  # Minecraft dataset: not ported
    skip_frames: int = 2  # Minecraft dataset: not ported

    n_model: int = 1  # > 1 not ported
    n_seq: int = 1  # > 1 not ported
    fsdp: bool = False  # not ported
    wandb: bool = False  # not ported
    project: str = "vq-video-diffusion"
    tags: str = ""
    name: str = "vq_diffusion"
    output_dir: str = "outputs/video_diffusion"
    checkpoint: str = ""
    # weights-only warm start: params/EMA, fresh optimizer/sampler, step 0
    init_from: str = ""
    eval: bool = False  # not ported
    topk: int = -1  # evaluation sampling: not ported


# flags kept for parity with the JAX CLI whose features are not ported:
# nothing reads them, so a value other than the default raises
_UNPORTED_FIELDS = {
    "data_workers": ("grain worker processes", "A.8"),
    "buffer_size": ("the Minecraft dataset's shuffle buffer", "A.8"),
    "skip_frames": ("the Minecraft dataset's frame skip", "A.8"),
    "histogram_interval": ("sampler-weight histograms (the metric logger)", "A.8"),
    "probe_interval": ("the timing report's device probes", "A.8"),
    "topk": ("evaluation sampling", "A.2"),
    "eval_timesteps": ("evaluation rollouts", "A.2"),
    "eval_batch_size": ("evaluation rollouts", "A.2"),
    "num_eval_iterations": ("evaluation rollouts", "A.2"),
}


def check_supported(cfg: VideoDiffusionConfig) -> None:
    """Raise NotImplementedError for options of features not ported."""
    check_defaults(cfg, _UNPORTED_FIELDS)
    if cfg.log_fence not in ("deferred", "sync"):
        raise ValueError(
            f"--log_fence must be 'deferred' or 'sync', got {cfg.log_fence!r}")
    if cfg.eval:
        raise unported("--eval (rollout evaluation and artifacts)", "A.2")
    if cfg.dataset != "moving_mnist":
        raise unported(f"--dataset {cfg.dataset}", "A.8")
    if cfg.data_pipeline != "native":
        raise unported(f"--data_pipeline {cfg.data_pipeline}", "A.8")
    if cfg.device_composite:
        raise unported("--device_composite", "A.8")
    if cfg.n_model > 1 or cfg.n_seq > 1 or cfg.fsdp:
        raise unported("--n_model / --n_seq / --fsdp parallelism", "A.9")
    if cfg.accumulation_steps > 1:
        raise unported("--accumulation_steps > 1", "A.8")
    if cfg.steps_per_dispatch > 1:
        raise unported("--steps_per_dispatch > 1", "A.8")
    if cfg.timing_report:
        raise unported("--timing_report", "A.8")
    if cfg.wandb:
        raise unported("--wandb (the metric logger)", "A.8")


def build_clip_fn(cfg: VideoDiffusionConfig, seed: int):
    """Host source of (B, n_past+1, H, W, C) uint8 clips, and the sampler
    to close (None for MovingMNIST)."""
    check_supported(cfg)
    rng = np.random.default_rng(seed)
    ds = MovingMNIST(
        data_root=cfg.data_dir or None,
        seq_len=cfg.n_past + 1,
        image_size=cfg.image_size,
        num_digits=cfg.num_digits,
        digit_size=cfg.digit_size,
        deterministic=False,
    )
    return (lambda b: ds.sample_batch_u8(rng, b)), None


def as_frames(batch: torch.Tensor) -> torch.Tensor:
    """uint8 clips -> float32 in [0, 1] (on the batch's device); float
    clips pass through."""
    if batch.dtype == torch.uint8:
        return batch.to(torch.float32) / 255.0
    return batch


def make_model(
    cfg: VideoDiffusionConfig,
    token_shape: Tuple[int, int, int],
    num_embeddings: int,
    device=None,
    backend: str = "auto",
) -> VqVideoDiffusionModel:
    """The denoiser with f32 (master) parameters, in train mode, with the
    attention ``backend`` (``Local3dAttention``'s)."""
    model = VqVideoDiffusionModel(
        data_shape=token_shape,
        dim=cfg.dim,
        num_classes=num_embeddings,
        extents=tuple(cfg.extents),
        depth=cfg.depth,
        mlp_dim=cfg.mlp_dim,
        dim_head=cfg.dim_head,
        heads=cfg.heads,
        dropout=cfg.dropout,
        backend=backend,
        device=device,
    )
    return model.train()


@dataclasses.dataclass
class StepDraws:
    """The random numbers of one step (JAX draws them from its step key)."""

    gumbel: torch.Tensor  # (B, num_buckets) sampler bucket Gumbel noise
    jitter: torch.Tensor  # (B,) sampler jitter uniforms
    mask_uniform: torch.Tensor  # (B, N) corruption mask uniforms
    resample_uniform: torch.Tensor  # (B, N) corruption resample uniforms
    uniform_classes: torch.Tensor  # (B, N) resampled class ids


def draw_step(
    generator: torch.Generator, b: int, n: int, num_buckets: int,
    num_classes: int,
) -> StepDraws:
    """One step's draws for a batch of ``b`` clips of ``n`` tokens per
    frame, from ``generator`` (on its device)."""
    dev = generator.device
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((b, num_buckets), generator=generator, device=dev)
    return StepDraws(
        gumbel=-torch.log(-torch.log(u.clamp_min(tiny))),
        jitter=torch.rand((b,), generator=generator, device=dev),
        mask_uniform=torch.rand((b, n), generator=generator, device=dev),
        resample_uniform=torch.rand((b, n), generator=generator, device=dev),
        uniform_classes=torch.randint(
            0, num_classes, (b, n), generator=generator, device=dev),
    )


@dataclasses.dataclass
class TrainState:
    """Everything a step updates. ``step`` counts steps taken, rejected
    ones included (the checkpoint's step); the optimizer counts the
    updates it applied (the schedule's step)."""

    # f32 master parameters (this trainer's denoiser, or the sparse one of
    # cli.sparse_diffusion, which shares this state and ce_step)
    model: torch.nn.Module
    optimizer: ScheduledOptimizer
    ema: Optional[Dict[str, torch.Tensor]]
    sampler: LossAwareSamplerState
    step: int = 0

    def state_dict(self) -> Dict:
        return {
            "params": self.model.state_dict(),
            "ema": self.ema if self.ema is not None else {},
            "opt_state": self.optimizer.state_dict(),
            "sampler": self.sampler.state_dict(),
        }

    @torch.no_grad()
    def load_state_dict(self, sd: Dict, step: int) -> None:
        self.model.load_state_dict(sd["params"], strict=True)
        if self.ema is not None:
            for k, v in self.ema.items():
                v.copy_(sd["ema"][k])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.sampler = LossAwareSamplerState.from_state_dict(
            sd["sampler"], self.model.device)
        self.step = step

    @torch.no_grad()
    def load_weights(self, sd: Dict) -> None:
        """A weights-only warm start (``--init_from``): the params, and the
        EMA from the checkpoint's EMA (or its params when it has none); the
        optimizer, sampler and step stay fresh."""
        self.model.load_state_dict(sd["params"], strict=True)
        if self.ema is not None:
            src = sd.get("ema") or sd["params"]
            for k, v in self.ema.items():
                v.copy_(src[k])


def init_state(cfg: VideoDiffusionConfig, model: VqVideoDiffusionModel) -> TrainState:
    schedule = warmup_cosine_schedule(cfg.lr, cfg.warmup, cfg.max_steps)
    opt = make_optimizer(cfg.optimizer, model.parameters(), schedule, cfg.weight_decay)
    ema = ema_init(dict(model.named_parameters())) if cfg.ema_decay > 0 else None
    return TrainState(model, opt, ema, loss_aware_init(device=model.device))


def train_step(
    state: TrainState,
    tok: VQAutoEncoder,
    frames: torch.Tensor,
    cfg: VideoDiffusionConfig,
    draws: StepDraws,
) -> Tuple[float, float, bool]:
    """One optimizer step (JAX ``step_body``, cli/video_diffusion.py:537-609)
    on a (B, S, H, W, C) clip batch; updates ``state`` in place and
    returns (loss, grad norm, ok) read on the host."""
    frames = as_frames(frames)
    b, s, hh, ww, c = frames.shape
    k = tok.num_embeddings
    tokens = tok.encode(frames.reshape(b * s, hh, ww, c)).long()
    tokens = tokens.reshape(b, s, *tokens.shape[1:])
    target = tokens[:, -1]

    r = loss_aware_sample(
        state.sampler, b, gumbel=draws.gumbel, jitter=draws.jitter)
    corrupted, _ = corrupt_tokens(
        target.reshape(b, -1), r, num_classes=k, mask_token=k,
        p_max_uniform=cfg.p_max_uniform,
        mask_uniform=draws.mask_uniform,
        resample_uniform=draws.resample_uniform,
        uniform_classes=draws.uniform_classes,
    )
    batch_z = tokens.clone()
    batch_z[:, -1] = corrupted.reshape(target.shape)

    return ce_step(state, (batch_z,), target, r, cfg)


def ce_step(
    state: TrainState,
    inputs: Tuple[torch.Tensor, ...],
    target: torch.Tensor,
    r: Optional[torch.Tensor],
    cfg,
) -> Tuple[float, float, bool]:
    """The part of a step the diffusion trainers share: the model's
    forward on ``inputs`` (bf16 on the f32 masters with ``cfg.bf16``),
    cross-entropy against ``target`` (B, ...), backward, the global grad
    norm, the step's one host read, then the guard: an accepted step
    updates the sampler with the per-sample losses at times ``r`` (None:
    no sampler update), applies AdamW and the EMA. Returns (loss, grad
    norm, ok)."""
    model = state.model
    params = dict(model.named_parameters())
    state.optimizer.zero_grad()
    if cfg.bf16:
        # a differentiable cast: the gradients land on the f32 masters
        low = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
               for n, p in params.items()}
        logits = torch.func.functional_call(model, low, inputs)
    else:
        logits = model(*inputs)
    ce = F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), target.reshape(-1),
        reduction="none")
    loss = ce.mean()
    loss.backward()
    grads = [p.grad for p in params.values() if p.grad is not None]
    gn = global_grad_norm(grads)
    ok = torch.isfinite(loss.detach()) & torch.isfinite(gn)
    # the step's one host sync: the guard decides on the host
    loss_v, gn_v, ok_v = torch.stack(
        [loss.detach(), gn, ok.to(torch.float32)]).tolist()
    ok_v = ok_v > 0.5
    if ok_v or not cfg.nan_guard:
        if r is not None:
            per_sample = ce.detach().reshape(target.shape[0], -1).mean(1)
            state.sampler = loss_aware_update(
                state.sampler, r, torch.nan_to_num(per_sample))
        if not ok_v:  # finite gradients are unchanged by nan_to_num
            for g in grads:
                g.nan_to_num_()
        state.optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, params, cfg.ema_decay)
    state.step += 1
    return loss_v, gn_v, ok_v


def checkpoint_restorer(saver: AsyncCheckpointSaver, state: TrainState, cfg):
    """The guard's escalation for the diffusion trainers: reload the newest
    complete checkpoint under ``cfg.output_dir`` (or ``cfg.checkpoint``)
    into ``state``; returns its path, or None when there is none."""

    def restore_latest() -> Optional[str]:
        saver.wait()  # an in-flight save must land first
        path = latest_checkpoint(cfg.output_dir) or cfg.checkpoint
        if not path:
            return None
        restored, at_step, _ = restore_checkpoint(path)
        state.load_state_dict(restored, at_step)
        print(f"[guard] restored {path} (step {at_step})")
        return path

    return restore_latest


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    # per step: (step, loss, grad_norm, ok, host clock after the step)
    history: List[Tuple[int, float, float, bool, float]]
    rejected: int
    token_shape: Tuple[int, int, int]


def train(cfg: VideoDiffusionConfig, *, backend: str = "auto") -> TrainResult:
    """Train as the JAX ``train`` does; returns the final state and each
    step's (loss, grad norm, ok). ``backend`` is the denoiser's attention
    backend (``"fused"``: the whole block in one kernel); the JAX trainer
    has no flag for it, so it is a keyword here, not a config field."""
    check_supported(cfg)
    device = platform_device(cfg.platform)
    if not cfg.decoder_model:
        raise ValueError("--decoder_model (tokenizer checkpoint) is required")
    if cfg.checkpoint and cfg.init_from:
        raise ValueError("--checkpoint (full resume) and --init_from "
                         "(weights-only) are mutually exclusive")
    torch.manual_seed(cfg.manual_seed)

    tok, _tok_cfg = load_tokenizer(cfg.decoder_model, device)
    if cfg.tok_bf16:
        tokenizer_inference_cast(tok)
    num_embeddings = tok.num_embeddings
    clip_fn, _ = build_clip_fn(cfg, cfg.manual_seed)

    # probe the token-grid shape from one encoded clip (main2.py:399-404)
    probe = as_frames(torch.from_numpy(clip_fn(1)).to(device))
    _, s, hh, ww, c = probe.shape
    if c != tok.in_channels:
        raise ValueError(
            f"data has {c} channels but the tokenizer was trained with "
            f"in_channels={tok.in_channels} (check --decoder_model vs "
            "--dataset)")
    z = tok.encode(probe[0])
    token_shape = (s, int(z.shape[1]), int(z.shape[2]))
    print("token grid:", token_shape)

    model = make_model(cfg, token_shape, num_embeddings, device, backend)
    print(f"parameters: {sum(p.numel() for p in model.parameters()):,}")
    state = init_state(cfg, model)
    if cfg.init_from:
        restored, at_step, _ = restore_checkpoint(cfg.init_from)
        state.load_weights(restored)
        print(f"warm start from {cfg.init_from} (step {at_step} weights; "
              "fresh optimizer, step 0)")
    if cfg.checkpoint:
        restored, at_step, _ = restore_checkpoint(cfg.checkpoint)
        state.load_state_dict(restored, at_step)
        print(f"resumed from {cfg.checkpoint} at step {at_step}")
    start_step = state.step
    if cfg.eval_interval and (
        (start_step // cfg.eval_interval + 1) * cfg.eval_interval
        <= cfg.max_steps
    ):
        raise unported(
            f"evaluation at eval_interval={cfg.eval_interval} (pass "
            "--eval_interval 0 to train without it)", "A.2")

    config = config_to_dict(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.manual_seed)
    n_tokens = token_shape[1] * token_shape[2]
    n_buckets = state.sampler.weights.shape[0]
    batches = PrefetchIterator(
        lambda: clip_fn(cfg.batch_size), depth=2, device=device)
    saver = AsyncCheckpointSaver()
    # the port reads every step's ok flag, so the guard counts steps (the
    # JAX trainer samples the flag at log points)
    guard = CheckpointGuard(checkpoint_restorer(saver, state, cfg))
    history: List[Tuple[int, float, float, bool, float]] = []
    rejected = 0
    try:
        while state.step < cfg.max_steps:
            frames = next(batches)
            draws = draw_step(gen, cfg.batch_size, n_tokens, n_buckets,
                              num_embeddings)
            loss, gn, ok = train_step(state, tok, frames, cfg, draws)
            step = state.step
            history.append((step, loss, gn, ok, time.perf_counter()))
            accepted = ok or not cfg.nan_guard
            if not accepted:
                rejected += 1
                print(f"{step}: step REJECTED (non-finite loss/grads)")
            guard.record(accepted, step)
            if step % cfg.log_interval == 0 or step == start_step + 1:
                lr = state.optimizer.schedule(step)
                print(f"{step}: loss {loss:.3e} lr {lr:.3e} "
                      f"grad_norm {gn:.3e}")
            if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                path = saver.save(cfg.output_dir, step, state.state_dict(), config)
                print("checkpoint:", path)
    finally:
        try:
            saver.wait()  # the last save must land before exit
        finally:
            batches.close()
    return TrainResult(state, history, rejected, token_shape)


def main(argv=None):
    cfg = dataclass_cli(VideoDiffusionConfig, argv)
    print("Config:", cfg)
    train(cfg)


if __name__ == "__main__":
    main()
