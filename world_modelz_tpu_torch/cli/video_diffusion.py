"""Masked video-diffusion training CLI (next-frame prediction).

Port of ``world_modelz_tpu.cli.video_diffusion`` (reference:
vq-video-diffusion/main.py, minecraft/main2.py):
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
- a JSONL metric log (``{output_dir}/{name}_metrics.jsonl``): loss, grad
  norm, lr and steps/s at each log point, the sampler weights' histogram
  every ``histogram_interval`` steps, and the evaluation grids
- evaluation every ``eval_interval`` steps, for the f32 masters and the
  EMA (``evaluate_and_save``, main2.py:59-146): an iterative-unmask rollout
  of ``eval_timesteps`` frames from ``eval_batch_size`` clips of its own
  data stream, decoded and written as a PNG grid and a GIF; ``--eval``
  evaluates a checkpoint's weights once (and writes each frame's grid) and
  returns

With ``bf16`` the f32 master weights are cast to a bf16 copy for the
forward (``torch.func.functional_call``); the cast is differentiable, so
the gradients land in f32 on the masters, as JAX's cast in ``loss_fn``.

The step (``step_body``) is one function of device tensors with no host
read, as JAX's ``step_body``: it always ``nan_to_num``s the gradients,
proposes the optimizer's, the EMA's and the sampler's new state, and keeps
the old state where the loss or the grad norm is not finite
(``train.guard.reject_nonfinite``), which leaves a rejected step's state
bitwise unchanged. It writes its packed (loss, grad norm, ok) into a row of
a (k, 3) device buffer; the loop reads the buffer once per dispatch of
``--steps_per_dispatch`` k steps (JAX's ``dispatch_len`` boundaries) and
records each step with the guard. On the CPU the step runs eagerly; on the
GPU it is captured once as a CUDA graph (``train.dispatch.StepProgram``)
and replayed at every k, k = 1 included, the clips and the draws copied
into its static inputs first, so any k gives bitwise the same state.
``--accumulation_steps`` is optax.MultiSteps (``train.optim``);
``--timing_report`` writes the JAX package's timing report
(``train.timing``).

The data (``build_clip_fn``, JAX's): ``--dataset moving_mnist`` ships uint8
clips, or with ``--device_composite`` each clip's sprites and positions,
composited inside the step (``data.device_composite``, inside the step's
CUDA graph on the card); ``synthetic`` and ``video`` (files under
``--data_dir``, decoded by OpenCV) ship uint8 clips of a
``BufferedTrajectorySampler`` (``buffer_size``, ``skip_frames``);
``--data_pipeline grain`` streams MovingMNIST or a ``TrajectoryClipDataset``
through Grain (``data_workers`` processes), and every checkpoint keeps the
consumed position (``grain_state.json``) that ``--checkpoint`` restores.
Every batch is normalized (or composited) on the device by ``as_frames``.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP item:
``--dataset minerl`` (the ``minerl`` package and its data are absent) and
parallelism. ``--wandb`` logs to the JSONL file only, as the JAX logger
does without the package.

Run (the GPU by default, ``--platform cpu`` for the CPU):

    python -m world_modelz_tpu_torch.cli.video_diffusion \\
        --decoder_model <tokenizer checkpoint>
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from world_modelz_tpu_torch._device import platform_device
from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer
from world_modelz_tpu_torch.data import (
    BufferedTrajectorySampler,
    MovingMNIST,
    PrefetchIterator,
    SyntheticTrajectorySource,
    VideoFileTrajectorySource,
    as_frames,
    batch_to,
)
from world_modelz_tpu_torch.diffusion import corrupt_tokens, rollout_frames
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
    host_schedule,
    latest_checkpoint,
    loss_aware_init,
    loss_aware_sample,
    loss_aware_update,
    loss_aware_weights,
    make_optimizer,
    pipeline_files,
    reject_nonfinite,
    restore_checkpoint,
    restore_pipeline,
    warmup_cosine_schedule,
)
from world_modelz_tpu_torch.serve import eval_mode
from world_modelz_tpu_torch.train.dispatch import (
    StepInputs,
    StepProgram,
    as_row,
    dispatch_len,
    log_point,
    record_steps,
    run_dispatch,
    step_inputs,
    write_timing,
)
from world_modelz_tpu_torch.train.timing import TrainTiming
from world_modelz_tpu_torch.utils.config import (
    config_to_dict,
    dataclass_cli,
    unported,
)
from world_modelz_tpu_torch.utils.image import make_grid, save_gif, save_image
from world_modelz_tpu_torch.utils.logging import MetricLogger


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

    dataset: str = "moving_mnist"  # moving_mnist|synthetic|video (minerl raises)
    # ship sprite trajectories instead of pixel clips and composite the
    # frames inside the step (data/device_composite.py; moving_mnist on the
    # native pipeline only). The gain needs steps_per_dispatch > 1: at 1
    # the loop reads every step's stats, and the prefetch thread's Python
    # (sample_batch_traj) holds the GIL while the loop feeds and launches
    # the next step, so the card waits on it
    device_composite: bool = False
    # "native" = the in-repo sources; "grain" = the deterministic,
    # checkpointable Grain stream (data/grain_pipeline.py)
    data_pipeline: str = "native"
    data_workers: int = 0  # grain worker processes (0 = in-process)
    data_dir: str = ""  # MNIST (mnist.npz) or the video files
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
    accumulation_steps: int = 1  # optax.MultiSteps mini-steps per update
    steps_per_dispatch: int = 1  # steps between host reads of the stats
    checkpoint_interval: int = 25_000
    eval_interval: int = 2000  # evaluation (base and EMA) every N steps
    eval_timesteps: int = 4  # frames each evaluation rollout generates
    eval_batch_size: int = 8  # clips each evaluation rolls out
    num_eval_iterations: int = 30  # unmask iterations per frame
    p_max_uniform: float = 0.1
    log_interval: int = 10
    # "deferred" or "sync": the port reads each dispatch's stats on the
    # host, so both modes log the step's own values (JAX's "sync" behaviour)
    log_fence: str = "deferred"
    histogram_interval: int = 50  # sampler-weight histograms (main2.py:298)
    timing_report: str = ""  # path of the timing report JSON (train/timing.py)
    probe_interval: int = 200  # device probes of the timing report

    dim: int = 256
    extents: Tuple[int, int, int] = (3, 3, 3)
    depth: int = 4
    mlp_dim: int = 256
    dim_head: int = 128
    heads: int = 1
    dropout: float = 0.0

    buffer_size: int = 100_000  # the trajectory sampler's buffer, in frames
    skip_frames: int = 2  # trajectory frames skipped between kept ones

    n_model: int = 1  # > 1 not ported
    n_seq: int = 1  # > 1 not ported
    fsdp: bool = False  # not ported
    wandb: bool = False  # without the wandb package: JSONL only
    project: str = "vq-video-diffusion"
    tags: str = ""
    name: str = "vq_diffusion"
    output_dir: str = "outputs/video_diffusion"
    checkpoint: str = ""
    # weights-only warm start: params/EMA, fresh optimizer/sampler, step 0
    init_from: str = ""
    eval: bool = False  # evaluate the --checkpoint's weights once, and exit
    topk: int = -1  # evaluation sampling: top-k logits (-1 = off)


def check_supported(cfg: VideoDiffusionConfig) -> None:
    """Raise NotImplementedError for options of features not ported, and
    ValueError for values the JAX CLI refuses too."""
    if cfg.log_fence not in ("deferred", "sync"):
        raise ValueError(
            f"--log_fence must be 'deferred' or 'sync', got {cfg.log_fence!r}")
    if cfg.dataset == "minerl":
        raise unported("--dataset minerl (the minerl package and its data)", "A.8")
    if cfg.dataset not in ("moving_mnist", "synthetic", "video"):
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    if cfg.data_pipeline not in ("native", "grain"):
        raise ValueError(f"unknown data_pipeline {cfg.data_pipeline!r}")
    if cfg.device_composite and (
            cfg.dataset != "moving_mnist" or cfg.data_pipeline != "native"):
        raise ValueError(
            "--device_composite needs the procedural moving_mnist source "
            "on the native pipeline (trajectories are a moving_mnist "
            "concept; grain batches are pixel records)")
    if cfg.n_model > 1 or cfg.n_seq > 1 or cfg.fsdp:
        raise unported("--n_model / --n_seq / --fsdp parallelism", "A.9")


def build_clip_fn(cfg: VideoDiffusionConfig, seed: int):
    """Host source of (B, n_past+1, ...) batches (JAX ``build_clip_fn``):
    ``clip_fn(b)`` gives uint8 (B, n_past+1, H, W, C) clips, or with
    ``device_composite`` a trajectory dict; ``as_frames`` makes frames of
    either on the device. Returns (clip_fn, the sampler or pipeline to
    close, or None for MovingMNIST's native source)."""
    check_supported(cfg)
    rng = np.random.default_rng(seed)
    grain = cfg.data_pipeline == "grain"
    if grain:
        from world_modelz_tpu_torch.data.grain_pipeline import GrainClipPipeline
    if cfg.dataset == "moving_mnist":
        ds = MovingMNIST(
            data_root=cfg.data_dir or None,
            seq_len=cfg.n_past + 1,
            image_size=cfg.image_size,
            num_digits=cfg.num_digits,
            digit_size=cfg.digit_size,
            deterministic=False,
        )
        if grain:  # float32 records
            pipe = GrainClipPipeline(ds, cfg.batch_size, seed=seed,
                                     worker_count=cfg.data_workers)
            return pipe.sample_batch, pipe
        if cfg.device_composite:
            return (lambda b: ds.sample_batch_traj(rng, b)), None
        return (lambda b: ds.sample_batch_u8(rng, b)), None
    if cfg.dataset == "video":
        src = VideoFileTrajectorySource(cfg.data_dir, frame_size=cfg.image_size)
    else:
        src = SyntheticTrajectorySource(frame_size=cfg.image_size)
    if grain:
        from world_modelz_tpu_torch.data.trajectory import TrajectoryClipDataset

        ds = TrajectoryClipDataset(src, traj_len=cfg.n_past + 1,
                                   skip_frames=cfg.skip_frames, seed=seed)
        pipe = GrainClipPipeline(ds, cfg.batch_size, seed=seed,
                                 worker_count=cfg.data_workers)
        return pipe.sample_batch, pipe
    sampler = BufferedTrajectorySampler(
        src, buffer_size=cfg.buffer_size, traj_len=cfg.n_past + 1,
        skip_frames=cfg.skip_frames, seed=seed)
    return sampler.sample_batch, sampler


def step_batch(batch) -> Dict[str, torch.Tensor]:
    """A batch as the step program's static inputs, the dict ``step_body``
    takes: ``{"frames": clips}``, or a trajectory dict's ``sprites`` and
    ``pos``."""
    return dict(batch) if isinstance(batch, dict) else {"frames": batch}


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

    @classmethod
    def empty(cls, b: int, n: int, num_buckets: int, device) -> "StepDraws":
        return cls(
            gumbel=torch.empty((b, num_buckets), device=device),
            jitter=torch.empty((b,), device=device),
            mask_uniform=torch.empty((b, n), device=device),
            resample_uniform=torch.empty((b, n), device=device),
            uniform_classes=torch.empty((b, n), dtype=torch.long, device=device))


def gumbel_(u: torch.Tensor) -> torch.Tensor:
    """Uniforms -> standard Gumbel noise, in place: -log(-log(u))."""
    return u.clamp_min_(torch.finfo(torch.float32).tiny).log_().neg_().log_().neg_()


def draw_step(
    generator: torch.Generator, b: int, n: int, num_buckets: int,
    num_classes: int, out: Optional[StepDraws] = None,
) -> StepDraws:
    """One step's draws for a batch of ``b`` clips of ``n`` tokens per
    frame, from ``generator`` (on its device), into ``out``'s tensors when
    given (a program's static inputs; the same numbers either way)."""
    if out is None:
        out = StepDraws.empty(b, n, num_buckets, generator.device)
    gumbel_(torch.rand((b, num_buckets), generator=generator, out=out.gumbel))
    torch.rand((b,), generator=generator, out=out.jitter)
    torch.rand((b, n), generator=generator, out=out.mask_uniform)
    torch.rand((b, n), generator=generator, out=out.resample_uniform)
    torch.randint(0, num_classes, (b, n), generator=generator, out=out.uniform_classes)
    return out


@dataclasses.dataclass
class TrainState:
    """Everything a step updates. ``step`` counts steps taken, rejected
    ones included (the checkpoint's step); the optimizer counts the
    updates it applied (the schedule's step). The parameters, the
    optimizer's buffers, the EMA (``ema_flat``, whose views ``ema`` holds by
    parameter name) and the sampler's tensors keep their addresses: every
    update and every restore writes into them in place, so a captured step
    keeps reading the live state."""

    # f32 master parameters (this trainer's denoiser, or the sparse one of
    # cli.sparse_diffusion, which shares this state and ce_step)
    model: torch.nn.Module
    optimizer: ScheduledOptimizer
    ema: Optional[Dict[str, torch.Tensor]]
    sampler: LossAwareSamplerState
    step: int = 0
    ema_flat: Optional[torch.Tensor] = None

    def tensors(self) -> List[torch.Tensor]:
        """The tensors a step writes."""
        out = list(self.optimizer.state_tensors().values())
        if self.ema_flat is not None:
            out.append(self.ema_flat)
        return out + [self.sampler.weights, self.sampler.counts]

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
        for k, v in self.sampler.state_dict().items():
            v.copy_(sd["sampler"][k])
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


def init_state(cfg, model: torch.nn.Module) -> TrainState:
    """A fresh state for ``model`` under ``cfg`` (either diffusion
    trainer's config): the optimizer (optax.MultiSteps with the config's
    ``accumulation_steps``), the EMA of the parameters when ``ema_decay`` >
    0, and the loss-aware sampler."""
    schedule = warmup_cosine_schedule(cfg.lr, cfg.warmup, cfg.max_steps)
    # JAX wraps the optimizer in optax.MultiSteps only for more than one step
    opt = make_optimizer(cfg.optimizer, model.parameters(), schedule, cfg.weight_decay,
                         accumulation_steps=max(1, getattr(cfg, "accumulation_steps", 1)))
    ema, ema_flat = None, None
    if cfg.ema_decay > 0:
        ema_flat = opt.flat.clone()
        names = [n for n, _ in model.named_parameters()]
        ema = dict(zip(names, opt.views(ema_flat)))
    return TrainState(model, opt, ema, loss_aware_init(device=model.device),
                      ema_flat=ema_flat)


def step_body(
    state: TrainState,
    tok: VQAutoEncoder,
    batch,
    cfg: VideoDiffusionConfig,
    draws: StepDraws,
) -> torch.Tensor:
    """One optimizer step (JAX ``step_body``, cli/video_diffusion.py:537-609)
    on a batch ``as_frames`` takes (the step program passes ``step_batch``'s
    dict: (B, S, H, W, C) clips, or sprites and positions composited here),
    on the device with no host read: updates ``state``'s tensors in place
    (not ``state.step``) and returns the packed (loss, grad norm, ok)
    float32 (3,) tensor."""
    frames = as_frames(batch, cfg.image_size)
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


def train_step(
    state: TrainState,
    tok: VQAutoEncoder,
    frames,
    cfg: VideoDiffusionConfig,
    draws: StepDraws,
) -> Tuple[float, float, bool]:
    """``step_body`` run eagerly, counted in ``state.step``, its (loss, grad
    norm, ok) read on the host."""
    stats = step_body(state, tok, frames, cfg, draws)
    state.step += 1
    return as_row(stats.tolist())


def ce_step(
    state: TrainState,
    inputs: Tuple[torch.Tensor, ...],
    target: torch.Tensor,
    r: Optional[torch.Tensor],
    cfg,
) -> torch.Tensor:
    """The part of a step the diffusion trainers share: the model's
    forward on ``inputs`` (bf16 on the f32 masters with ``cfg.bf16``),
    cross-entropy against ``target`` (B, ...), backward, the global grad
    norm, then JAX's update and guard on the device: the gradients
    ``nan_to_num``ed, the optimizer's proposal, the EMA of the proposed
    parameters and the sampler updated with the per-sample losses at times
    ``r`` (None: no sampler update); with ``cfg.nan_guard`` the old state is
    kept where the loss or the grad norm is not finite. Writes the state in
    place and returns the packed (loss, grad norm, ok) float32 (3,)
    tensor. With ``cfg.moe_experts`` > 0 (the sparse trainer's
    mixture-of-experts FFNs) the loss also carries ``cfg.moe_aux_weight``
    times the layers' mean load-balance loss, as JAX's ``loss_fn``."""
    model = state.model
    opt = state.optimizer
    opt.zero_grad()
    moe = getattr(cfg, "moe_experts", 0) > 0
    kwargs = {"return_aux": True} if moe else {}
    if cfg.bf16:
        # a differentiable cast: the gradients land on the f32 masters
        low = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
               for n, p in model.named_parameters()}
        out = torch.func.functional_call(model, low, inputs, kwargs)
    else:
        out = model(*inputs, **kwargs)
    logits, aux = out if moe else (out, None)
    ce = F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), target.reshape(-1),
        reduction="none")
    loss = ce.mean()
    if moe:
        loss = loss + cfg.moe_aux_weight * aux
    loss.backward()
    with torch.no_grad():
        loss = loss.detach()
        g = opt.flat_grad()
        gn = torch.linalg.vector_norm(g)
        ok = torch.isfinite(loss) & torch.isfinite(gn)
        old = {"opt": opt.state_tensors()}
        new = {"opt": opt.propose(torch.nan_to_num(g))}
        if state.ema_flat is not None:
            d = cfg.ema_decay
            old["ema"] = state.ema_flat
            new["ema"] = state.ema_flat * d + new["opt"]["params"] * (1.0 - d)
        if r is not None:
            per_sample = ce.detach().reshape(target.shape[0], -1).mean(1)
            upd = loss_aware_update(state.sampler, r, torch.nan_to_num(per_sample))
            old["sampler"] = {"weights": state.sampler.weights,
                              "counts": state.sampler.counts}
            new["sampler"] = {"weights": upd.weights, "counts": upd.counts}
        if cfg.nan_guard:
            new = reject_nonfinite(ok, old, new)
        opt.assign(new["opt"])
        if "ema" in new:
            state.ema_flat.copy_(new["ema"])
        if "sampler" in new:
            state.sampler.weights.copy_(new["sampler"]["weights"])
            state.sampler.counts.copy_(new["sampler"]["counts"])
        return torch.stack([loss.float(), gn, ok.to(torch.float32)])


def step_program(state: TrainState, io: StepInputs,
                 body: Callable[[], torch.Tensor]) -> StepProgram:
    """The program of one step: ``body()`` (the step on ``io``'s buffers)
    recorded into ``io``'s stats."""
    return StepProgram(lambda: io.record(body()), state.model.device,
                       keep=lambda: state.tensors() + [io.stats, io.row], inputs=io)


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


def evaluate_and_save(
    *,
    cfg: VideoDiffusionConfig,
    model: VqVideoDiffusionModel,
    weights: Optional[Dict[str, torch.Tensor]],
    tok: VQAutoEncoder,
    clip_fn: Callable[[int], np.ndarray],
    generator: torch.Generator,
    tag: str,
    step: int,
    logger: Optional[MetricLogger] = None,
    save_frames: bool = False,
) -> str:
    """Rollout, decode and artifacts (JAX ``evaluate_and_save``,
    cli/video_diffusion.py:300-368; main2.py:59-146).

    Encodes ``eval_batch_size`` clips of ``clip_fn``, rolls out
    ``eval_timesteps`` frames (``num_eval_iterations`` unmask iterations,
    top-k ``topk``) with the denoiser in eval mode, with ``weights`` (e.g.
    the EMA's) in place of its own parameters when given, and noise from
    ``generator``; decodes, and writes the PNG grid (one row per frame, the
    seed frame first, one column per clip) and a GIF of its rows at 4 fps
    under ``cfg.output_dir`` (with ``save_frames``, one PNG per row too).
    ``logger`` records the grid (``log_image``). Returns the PNG's path."""
    frames = as_frames(batch_to(clip_fn(cfg.eval_batch_size), tok.device), cfg.image_size)
    b, s, hh, ww, c = frames.shape
    tokens = tok.encode(frames.reshape(b * s, hh, ww, c))
    tokens = tokens.reshape(b, s, *tokens.shape[1:])
    if weights is None:
        logits_fn = model
    else:
        def logits_fn(z):
            return torch.func.functional_call(model, weights, (z,))
    k = tok.num_embeddings
    with torch.no_grad(), eval_mode(model):
        gen_tokens = rollout_frames(
            logits_fn, tokens, num_frames=cfg.eval_timesteps, num_classes=k,
            mask_token=k, num_iterations=cfg.num_eval_iterations,
            sample_topk=cfg.topk, generator=generator,
        )  # (B, T, h, w)
    t = gen_tokens.shape[1]
    decoded = tok.decode(gen_tokens.reshape(b * t, *gen_tokens.shape[2:]))
    decoded = decoded.float().cpu().numpy().reshape(b, t, *decoded.shape[1:])
    seed_frame = frames[:, -1].float().cpu().numpy()

    # one row per frame, the clips across (eval_model_and_save's layout)
    all_frames = np.concatenate([seed_frame[:, None], decoded], axis=1)
    grid = make_grid(
        all_frames.transpose(1, 0, 2, 3, 4).reshape(-1, *all_frames.shape[2:]),
        nrow=b,
    )
    os.makedirs(cfg.output_dir, exist_ok=True)
    fn = os.path.join(cfg.output_dir, f"{cfg.name}_eval_{step:07d}_{tag}.png")
    save_image(grid, fn)
    rows = [make_grid(all_frames[:, i], nrow=b) for i in range(t + 1)]
    save_gif(rows, fn[: -len(".png")] + ".gif", fps=4)
    if save_frames:
        for i, row in enumerate(rows):
            save_image(row, os.path.join(
                cfg.output_dir, f"{cfg.name}_{tag}_frame_{i:04d}.png"))
    if logger is not None:
        logger.log_image(step, f"reconstruction_{tag}", grid)
    print("eval artifact:", fn)
    return fn


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    # per step: (step, loss, grad_norm, ok, host clock after the step)
    history: List[Tuple[int, float, float, bool, float]]
    rejected: int
    token_shape: Tuple[int, int, int]
    # per evaluation: (step, tag, PNG path, wall seconds)
    evals: List[Tuple[int, str, str, float]]
    # the step program (its graph's launches on the GPU), the timing report
    program: Optional[StepProgram] = None
    timing: Optional[Dict] = None


def train(cfg: VideoDiffusionConfig, *, backend: str = "auto") -> TrainResult:
    """Train as the JAX ``train`` does (or, with ``cfg.eval``, evaluate the
    ``cfg.checkpoint``'s weights once); returns the final state, each
    step's (loss, grad norm, ok) and the evaluations written. ``backend``
    is the denoiser's attention backend (``"fused"``: the whole block in
    one kernel); the JAX trainer has no flag for it, so it is a keyword
    here, not a config field."""
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
    clip_fn, sampler = build_clip_fn(cfg, cfg.manual_seed)
    # evaluation draws clips from a stream of its own where JAX's does (the
    # training stream belongs to the prefetch thread, and a Grain position
    # must not move for it); the buffered trajectory sampler is shared, as
    # JAX shares it
    eval_sampler = None
    if cfg.dataset == "moving_mnist" or cfg.data_pipeline == "grain":
        eval_clip_fn, eval_sampler = build_clip_fn(cfg, cfg.manual_seed + 101)
    else:
        eval_clip_fn = clip_fn
    eval_gen = torch.Generator(device=device).manual_seed(cfg.manual_seed + 101)
    try:
        return _train(cfg, backend, device, tok, clip_fn, sampler, eval_clip_fn, eval_gen)
    finally:
        for s in (sampler, eval_sampler):
            if s is not None:
                s.close()


def _train(cfg, backend, device, tok, clip_fn, sampler, eval_clip_fn, eval_gen) -> TrainResult:
    """The rest of ``train``, on its tokenizer and data sources (``train``
    closes the sources)."""
    num_embeddings = tok.num_embeddings
    # probe the token-grid shape from one encoded clip (main2.py:399-404)
    probe = as_frames(batch_to(clip_fn(1), device), cfg.image_size)
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
    lr_of = host_schedule(state.optimizer.schedule)
    if cfg.init_from and not cfg.eval:
        restored, at_step, _ = restore_checkpoint(cfg.init_from)
        state.load_weights(restored)
        print(f"warm start from {cfg.init_from} (step {at_step} weights; "
              "fresh optimizer, step 0)")
    evals: List[Tuple[int, str, str, float]] = []
    if cfg.eval:
        # eval-only: the checkpoint's weights suffice (as JAX, :469-535);
        # unlike the JAX CLI, the grid also goes to the metric log
        if cfg.checkpoint:
            restored, state.step, _ = restore_checkpoint(cfg.checkpoint)
            model.load_state_dict(restored["params"], strict=True)
            restore_pipeline(sampler, cfg.checkpoint)
            print(f"evaluating {cfg.checkpoint} (step {state.step})")
        logger = MetricLogger(cfg.output_dir, cfg.name)
        try:
            te = time.perf_counter()
            path = evaluate_and_save(
                cfg=cfg, model=model, weights=None, tok=tok, clip_fn=clip_fn,
                generator=torch.Generator(device=device).manual_seed(cfg.manual_seed),
                tag="base", step=state.step, logger=logger, save_frames=True)
            evals.append((state.step, "base", path, time.perf_counter() - te))
        finally:
            logger.close()
        return TrainResult(state, [], 0, token_shape, evals)
    if cfg.checkpoint:
        restored, at_step, _ = restore_checkpoint(cfg.checkpoint)
        state.load_state_dict(restored, at_step)
        restore_pipeline(sampler, cfg.checkpoint)
        print(f"resumed from {cfg.checkpoint} at step {at_step}")
    start_step = state.step

    config = config_to_dict(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.manual_seed)
    n_tokens = token_shape[1] * token_shape[2]
    n_buckets = state.sampler.weights.shape[0]
    kdisp = max(1, cfg.steps_per_dispatch)
    batches = PrefetchIterator(
        lambda: clip_fn(cfg.batch_size),
        # a dispatch drains k batches at once: keep the worker a dispatch ahead
        depth=max(2, kdisp + 1), device=device,
        probe_every=5 * kdisp if cfg.timing_report else 0,
        # a Grain position rides the queue with its batch: a checkpoint
        # records the position consumed, not the one prefetched ahead
        state_fn=getattr(sampler, "get_state", None))
    logger = MetricLogger(cfg.output_dir, cfg.name, use_wandb=cfg.wandb,
                          project=cfg.project, config=config, tags=cfg.tags)
    saver = AsyncCheckpointSaver()
    # the port reads every step's ok flag, so the guard counts steps (the
    # JAX trainer samples the flag at log points)
    guard = CheckpointGuard(checkpoint_restorer(saver, state, cfg))
    tm = TrainTiming(probe_interval=cfg.probe_interval if cfg.timing_report else 0)
    history: List[Tuple[int, float, float, bool, float]] = []
    rejected = 0
    io: Optional[StepInputs] = None
    program: Optional[StepProgram] = None
    seen_sizes = set()  # dispatch lengths already run

    def feed(batch):
        """A step's batch (its clips, or sprites and positions) and draws
        into the program's inputs."""
        for k, v in step_batch(batch).items():
            io.tensors[k].copy_(v)
        draw_step(gen, cfg.batch_size, n_tokens, n_buckets, num_embeddings,
                  out=io.draws)

    t0 = time.time()
    try:
        while state.step < cfg.max_steps:
            step = state.step
            n = dispatch_len(step, kdisp, cfg.max_steps, start_step + 1, (
                cfg.log_interval, cfg.histogram_interval, cfg.checkpoint_interval,
                cfg.eval_interval, tm.probe_interval))
            tt = time.perf_counter()
            frame_list = [next(batches) for _ in range(n)]
            tm.add("data", time.perf_counter() - tt)
            if program is None:
                io = step_inputs({k: torch.empty_like(v)
                                  for k, v in step_batch(frame_list[0]).items()},
                                 StepDraws.empty(cfg.batch_size, n_tokens, n_buckets, device),
                                 kdisp)
                program = step_program(state, io, lambda: step_body(
                    state, tok, io.tensors, cfg, io.draws))
            rows = run_dispatch(program, io, tm, step, [
                functools.partial(feed, f) for f in frame_list], frame_list[-1], seen_sizes)
            rejected += record_steps(history, guard, rows, step, cfg, state)
            step += n
            if step % cfg.log_interval == 0 or step == start_step + 1:
                t0 = log_point(logger, tm, rows[-1], step, lr_of(step), cfg, t0,
                               start_step, kdisp, seen_sizes)
            if cfg.histogram_interval and step % cfg.histogram_interval == 0:
                logger.log_histogram(step, "sampler_weights",
                                     loss_aware_weights(state.sampler))
            if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                tt = time.perf_counter()
                path = saver.save(cfg.output_dir, step, state.state_dict(), config,
                                  pipeline_files(batches.consumed_state()))
                tm.add("checkpoint", time.perf_counter() - tt)
                print("checkpoint:", path)
            if cfg.eval_interval and step % cfg.eval_interval == 0:
                for tag, weights in (("base", None), ("ema", state.ema)):
                    if tag == "ema" and weights is None:
                        continue
                    te = time.perf_counter()
                    path = evaluate_and_save(
                        cfg=cfg, model=model, weights=weights, tok=tok,
                        clip_fn=eval_clip_fn, generator=eval_gen, tag=tag,
                        step=step, logger=logger)
                    evals.append((step, tag, path, time.perf_counter() - te))
                    tm.add("eval", time.perf_counter() - te)
    finally:
        try:
            saver.wait()  # the last save must land before exit
        finally:
            report = write_timing(tm, cfg, batches, {"token_shape": list(token_shape)},
                                  config)
            batches.close()
            logger.close()
    return TrainResult(state, history, rejected, token_shape, evals, program, report)


def main(argv=None):
    cfg = dataclass_cli(VideoDiffusionConfig, argv)
    print("Config:", cfg)
    train(cfg)


if __name__ == "__main__":
    main()
