"""Sparse space-time diffusion training CLI.

Port of ``world_modelz_tpu.cli.sparse_diffusion`` (reference:
minecraft/sparse_diffusion.py:272-543): train a dense transformer denoiser
on random ``num_context``-token subsets of (S, H, W) token volumes, the
positions drawn from time-dependent temporal windows ("neighbors") or
uniformly, with
- amortized tokenization: a fresh trajectory batch is encoded (through the
  ``vq_encode`` kernel) only every ``change_batch_interval`` steps
  (:412-425);
- loss-aware or uniform diffusion-time sampling, masked corruption of the
  gathered tokens, cross-entropy on all N tokens;
- the bf16 forward on f32 masters (``torch.func.functional_call``; the
  cast is differentiable, so the gradients land in f32, as JAX's cast in
  ``loss_fn``), whose attention runs the flash kernels when N >= 1024 or
  with ``--attn_backend flash``;
- warmup + cosine AdamW, EMA, the non-finite guard on the device (a
  rejected step leaves the state bitwise unchanged), the step
  (``step_body``) shared with the video trainer as ``ce_step``: eager on the
  CPU, one CUDA graph replayed on the GPU at every ``--steps_per_dispatch``
  (``train.dispatch``), its stats read once per dispatch; the batch refresh
  stays outside the step, at JAX's steps, and a dispatch ends at it;
- evaluation: the chunked volume sweep (``sparse_denoise_volume``), decoded
  to frames and written as a PNG grid, for the base and the EMA weights;
- ``--moe_experts``: every FFN a top-1 mixture of experts
  (``models.attention.MoEFeedForward``, ``--moe_capacity_factor``), its
  load-balance loss weighted by ``--moe_aux_weight`` in the objective,
  inside the step graph;
- ``--tokenizer``: an external tokenizer (``models.external``,
  ``native:<checkpoint>`` or ``taming:<config.yaml>,<model.ckpt>``) in
  place of ``--decoder_model``, for the batch encode and the evaluation's
  decode;
- async checkpoints with the embedded config, resume, warm start and
  ``--single_batch`` (with its ``gt.png``);
- a JSONL metric log: loss, grad norm, lr and steps/s at each log point,
  and the sampler weights' histogram every ``histogram_interval`` steps
  (none under ``--uniform_noise``).

``--timing_report`` writes the JAX package's timing report; ``--wandb``
logs to the JSONL file only, as the JAX logger does without the package.

The data: ``--dataset synthetic`` (procedural trajectories) or ``video``
(the video files under ``--mlr_data_dir``, decoded by OpenCV), clips of a
``BufferedTrajectorySampler``, or with ``--data_pipeline grain`` of a
``TrajectoryClipDataset`` streamed through Grain (``data_workers``
processes), whose consumed position every checkpoint keeps
(``grain_state.json``) and ``--checkpoint`` restores.

The data axis, as the video trainer's (``cli.video_diffusion``): under
``torchrun`` the global batch splits over the processes (samplers seeded by
(seed, rank)), the gradient is averaged over them (or reduce-scattered to
shards with ``--fsdp``), the mixture-of-experts load-balance means are the
global batch's, and rank 0 alone writes.

The model axes (``parallel.mesh.make_mesh``): ``--n_model`` splits the
attention by heads (each of q, k and v of the fused projection) and the
FFNs over the model axis, and with ``--moe_experts`` the experts
(E / n_model a rank, one all-reduce to combine them); ``--n_pipe`` streams
``n_micro`` microbatches of each rank's rows through ``n_pipe`` stages of
the layer stack (``parallel.pipelined_sparse``; not with MoE or
``--fsdp``, as in JAX). Checkpoints are whole, and the evaluation runs the
plain model on the gathered weights on rank 0.

Not ported, and raising ``NotImplementedError`` with the ROADMAP item: the
MineRL dataset (A.8: the ``minerl`` package and its data are absent).

Run (the GPU by default, ``--platform cpu`` for the CPU):

    python -m world_modelz_tpu_torch.cli.sparse_diffusion \\
        --decoder_model <tokenizer checkpoint> --S 16 --num_context 1024 \\
        --heads 8 --attn_backend flash
    torchrun --nproc_per_node 4 -m world_modelz_tpu_torch.cli.sparse_diffusion \\
        --decoder_model <tokenizer checkpoint> --n_pipe 2 --n_micro 4
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from world_modelz_tpu_torch._device import platform_device
from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer
from world_modelz_tpu_torch.cli.video_diffusion import (
    TrainState,
    ce_step,
    checkpoint_restorer,
    gumbel_,
    init_state,
    step_program,
)
from world_modelz_tpu_torch.data import (
    BufferedTrajectorySampler,
    PrefetchIterator,
    SyntheticTrajectorySource,
    TrajectoryClipDataset,
    VideoFileTrajectorySource,
)
from world_modelz_tpu_torch.diffusion import (
    corrupt_tokens,
    sample_flat_positions,
    sample_time_dependent,
    sparse_denoise_volume,
)
from world_modelz_tpu_torch.models import VQAutoEncoder, VqSparseDiffusionModel
from world_modelz_tpu_torch.models.external import FrameTokenizer, make_tokenizer
from world_modelz_tpu_torch.parallel.distributed import (
    initialize_distributed,
    process_device,
    local_rows,
    rank_seed,
)
from world_modelz_tpu_torch.parallel.mesh import check_batch, make_mesh
from world_modelz_tpu_torch.train import (
    AsyncCheckpointSaver,
    CheckpointGuard,
    host_schedule,
    loss_aware_sample,
    loss_aware_weights,
    pipeline_files,
    restore_checkpoint,
    restore_pipeline,
    uniform_sample,
)
from world_modelz_tpu_torch.train.dispatch import (
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
from world_modelz_tpu_torch.utils import tracing
from world_modelz_tpu_torch.utils.config import (
    config_to_dict,
    dataclass_cli,
    unported,
)
from world_modelz_tpu_torch.utils.image import make_grid, save_image
from world_modelz_tpu_torch.utils.logging import rank_logger

# the in-repo tokenizer or an external one: both encode (B, H, W, C) [0, 1]
# images to (B, h, w) tokens and decode them back
Tokenizer = Union[VQAutoEncoder, FrameTokenizer]


@dataclasses.dataclass
class SparseDiffusionConfig:
    """Flags mirror minecraft/sparse_diffusion.py:213-269 (field names and
    defaults of the JAX package's config)."""

    manual_seed: int = 42
    platform: str = ""  # "" = the GPU (raises without one), "cpu"
    lr: float = 5e-5
    batch_size: int = 48
    eval_batch_size: int = 8
    save_frames: bool = False
    max_steps: int = 500_000
    warmup: int = 500
    weight_decay: float = 1e-2
    optimizer: str = "AdamW"
    ema_decay: float = 0.0
    bf16: bool = False  # bfloat16 compute with f32 master weights
    nan_guard: bool = True  # reject steps with non-finite loss/grads
    checkpoint: str = ""  # resume path
    # weights-only warm start: params/EMA, fresh optimizer/sampler, step 0
    init_from: str = ""

    decoder_model: str = ""  # tokenizer checkpoint (required without --tokenizer)
    # external tokenizer spec: "native:<checkpoint>" or
    # "taming:<config.yaml>,<model.ckpt>" (models/external.py)
    tokenizer: str = ""
    dataset: str = "synthetic"  # synthetic|video (minerl raises)
    mlr_data_dir: str = ""  # the video files (--dataset video)
    image_size: int = 64

    S: int = 32
    H: int = 16
    W: int = 16

    single_batch: bool = False
    eval_interval: int = 1000
    num_eval_iterations: int = 100
    checkpoint_interval: int = 25_000
    sampling_type: str = "neighbors"  # uniform|neighbors
    p_max_uniform: float = 0.1
    uniform_noise: bool = False
    log_interval: int = 10
    # "deferred" or "sync": the port reads each dispatch's stats on the
    # host, so both modes log the step's own values (JAX's "sync" behaviour)
    log_fence: str = "deferred"
    # sampler-weight histograms (none under uniform_noise)
    histogram_interval: int = 50
    timing_report: str = ""  # path of the timing report JSON (train/timing.py)
    probe_interval: int = 200  # device probes of the timing report

    buffer_size: int = 75_000
    max_segment_length: int = 1000
    skip_frames: int = 2
    # "native" = BufferedTrajectorySampler; "grain" = the deterministic,
    # checkpointable Grain stream (data/grain_pipeline.py)
    data_pipeline: str = "native"
    data_workers: int = 0  # grain worker processes (0 = in-process)

    dim: int = 512
    mlp_dim: int = 1024
    heads: int = 4
    depth: int = 8
    num_context: int = 512
    change_batch_interval: int = 4
    steps_per_dispatch: int = 1  # steps between host reads of the stats
    # dense-attention backend: auto | flash | xla (models.attention.
    # DenseAttention); auto takes the flash kernels on the GPU from 1024
    # tokens on
    attn_backend: str = "auto"

    # mixture-of-experts FFNs (models/attention.py MoEFeedForward): every
    # FFN becomes moe_experts top-1-routed experts
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2  # load-balance loss weight

    n_model: int = 1  # tensor-parallel axis (experts over it with MoE)
    # shard the optimizer's side over the data axis (parallel/fsdp.py): each
    # rank updates 1 / world of the f32 parameters and holds that part of
    # Adam's moments and the EMA; reduce-scattered gradients, the updated
    # parameters all-gathered, whole on every rank
    fsdp: bool = False
    # pipeline parallelism (parallel/pipelined_sparse.py): n_pipe stages
    # stream n_micro microbatches; depth % n_pipe == 0 and
    # batch_size % n_micro == 0. Deterministic path (dropout 0)
    n_pipe: int = 1
    n_micro: int = 4
    wandb: bool = False  # without the wandb package: JSONL only
    project: str = "sparse_diffusion"
    tags: str = ""
    name: str = "sparse_diffusion"
    output_dir: str = "outputs/sparse_diffusion"


def check_supported(cfg: SparseDiffusionConfig) -> None:
    """Raise NotImplementedError for options of features not ported, and
    ValueError for values the JAX CLI does not take either."""
    if cfg.log_fence not in ("deferred", "sync"):
        raise ValueError(
            f"--log_fence must be 'deferred' or 'sync', got {cfg.log_fence!r}")
    if cfg.sampling_type not in ("uniform", "neighbors"):
        raise ValueError(
            f"--sampling_type must be 'uniform' or 'neighbors', got "
            f"{cfg.sampling_type!r}")
    if cfg.dataset == "minerl":
        raise unported("--dataset minerl (the minerl package and its data)", "A.8")
    if cfg.dataset not in ("synthetic", "video"):
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    if cfg.data_pipeline not in ("native", "grain"):
        raise ValueError(f"unknown data_pipeline {cfg.data_pipeline!r}")
    if cfg.moe_experts > 0 and cfg.n_pipe > 1:
        raise ValueError(
            "--moe_experts cannot combine with --n_pipe (the pipelined "
            "forward does not thread the MoE aux-loss collection)")
    if cfg.fsdp and cfg.n_pipe > 1:
        raise ValueError(
            "--fsdp cannot combine with --n_pipe: pipeline stages own "
            "their params per 'pipe' device; gathering them over 'data' "
            "would serialize the schedule")
    if cfg.n_pipe > 1:
        if cfg.depth % cfg.n_pipe:
            raise ValueError(f"depth {cfg.depth} not divisible by {cfg.n_pipe} stages")
        if cfg.batch_size % cfg.n_micro:
            raise ValueError(f"batch {cfg.batch_size} not divisible by n_micro {cfg.n_micro}")


def build_sampler(cfg: SparseDiffusionConfig, seed: Optional[int] = None):
    """The JAX trainer's clip source (cli/sparse_diffusion.py:237-274):
    synthetic trajectories or video files, in its buffered sampler or, with
    ``--data_pipeline grain``, a Grain stream of a ``TrajectoryClipDataset``;
    ``sample_batch(b)`` gives (b, S, H, W, 3) uint8 clips, ``close()``
    stops it. ``seed`` (default ``cfg.manual_seed``) seeds the sampling."""
    seed = cfg.manual_seed if seed is None else seed
    if cfg.dataset == "video":
        src = VideoFileTrajectorySource(cfg.mlr_data_dir, frame_size=cfg.image_size)
    else:
        src = SyntheticTrajectorySource(
            num_trajectories=16,
            traj_frames=max(3 * cfg.S * (cfg.skip_frames + 1), 200),
            frame_size=cfg.image_size,
        )
    if cfg.data_pipeline == "grain":
        from world_modelz_tpu_torch.data.grain_pipeline import GrainClipPipeline

        return GrainClipPipeline(
            TrajectoryClipDataset(src, traj_len=cfg.S, skip_frames=cfg.skip_frames,
                                  seed=seed),
            cfg.batch_size, seed=seed, worker_count=cfg.data_workers)
    return BufferedTrajectorySampler(
        src, buffer_size=cfg.buffer_size,
        max_segment_length=cfg.max_segment_length, traj_len=cfg.S,
        skip_frames=cfg.skip_frames, seed=seed,
    )


def make_model(
    cfg: SparseDiffusionConfig, num_embeddings: int, device=None
) -> VqSparseDiffusionModel:
    """The denoiser with f32 (master) parameters, in train mode."""
    model = VqSparseDiffusionModel(
        shape=(cfg.S, cfg.H, cfg.W),
        dim=cfg.dim,
        num_classes=num_embeddings,
        depth=cfg.depth,
        dim_head=cfg.dim // cfg.heads,
        mlp_dim=cfg.mlp_dim,
        heads=cfg.heads,
        attn_backend=cfg.attn_backend,
        moe_experts=cfg.moe_experts,
        moe_capacity_factor=cfg.moe_capacity_factor,
        device=device,
    )
    return model.train()


def encode_batch(tok: Tokenizer, frames: torch.Tensor,
                 shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, S, H, W, C) uint8 frames -> (B, S, h, w) tokens (int64), through
    the tokenizer or an external ``FrameTokenizer`` (the span
    ``sparse.encode``)."""
    b, s, hh, ww, c = frames.shape
    if c != tok.in_channels:
        raise ValueError(
            f"data has {c} channels but the tokenizer was trained with "
            f"in_channels={tok.in_channels} (check --decoder_model vs "
            "--dataset)")
    with tracing.span("sparse.encode"):
        z = tok.encode(frames.reshape(b * s, hh, ww, c).to(torch.float32) / 255.0)
        z = z.reshape(b, s, *z.shape[1:]).long()
    if tuple(z.shape[1:]) != tuple(shape):
        raise ValueError(
            f"the tokenizer gives {tuple(z.shape[1:])} token volumes, the "
            f"config says (S, H, W) = {tuple(shape)}")
    return z


@torch.no_grad()
def decode_volume(tok: Tokenizer, volume: torch.Tensor,
                  decode_n: int = 16) -> np.ndarray:
    """Chunked decode of a (B, S, h, w) token volume to (B, S, H, W, C)
    frames, mask tokens clamped to 0 (sparse_diffusion.py:118-136),
    through the tokenizer or an external ``FrameTokenizer``."""
    volume = torch.where(volume >= tok.num_embeddings, 0, volume)
    b, s, h, w = volume.shape
    flat = volume.reshape(b * s, h, w)
    frames = np.concatenate([
        tok.decode(flat[i : i + decode_n]).float().cpu().numpy()
        for i in range(0, flat.shape[0], decode_n)
    ])
    return frames.reshape(b, s, *frames.shape[1:])


@dataclasses.dataclass
class StepDraws:
    """The random numbers of one step (JAX draws them from its step key)."""

    gumbel: torch.Tensor  # (B, num_buckets) sampler bucket Gumbel noise
    # (B,) the sampler's jitter uniforms, or the times themselves with
    # uniform_noise
    jitter: torch.Tensor
    offset_uniform: torch.Tensor  # (B,) window offsets ("neighbors")
    position_uniform: torch.Tensor  # (B, volume) position sort keys
    mask_uniform: torch.Tensor  # (B, N) corruption mask uniforms
    resample_uniform: torch.Tensor  # (B, N) corruption resample uniforms
    uniform_classes: torch.Tensor  # (B, N) resampled class ids

    @classmethod
    def empty(cls, b: int, n: int, volume: int, num_buckets: int,
              device) -> "StepDraws":
        def f(*shape):
            return torch.empty(shape, device=device)

        return cls(gumbel=f(b, num_buckets), jitter=f(b), offset_uniform=f(b),
                   position_uniform=f(b, volume), mask_uniform=f(b, n),
                   resample_uniform=f(b, n),
                   uniform_classes=torch.empty((b, n), dtype=torch.long, device=device))


def draw_step(
    generator: torch.Generator, b: int, n: int, volume: int,
    num_buckets: int, num_classes: int, out: Optional[StepDraws] = None,
) -> StepDraws:
    """One step's draws for a batch of ``b`` volumes of ``volume`` tokens
    and ``n`` context tokens, from ``generator`` (on its device), into
    ``out``'s tensors when given (the same numbers either way)."""
    if out is None:
        out = StepDraws.empty(b, n, volume, num_buckets, generator.device)
    for t in (out.gumbel, out.jitter, out.offset_uniform, out.position_uniform,
              out.mask_uniform, out.resample_uniform):
        torch.rand(t.shape, generator=generator, out=t)
    gumbel_(out.gumbel)
    torch.randint(0, num_classes, (b, n), generator=generator, out=out.uniform_classes)
    return out


def step_body(
    state: TrainState,
    batch_z: torch.Tensor,
    cfg: SparseDiffusionConfig,
    draws: StepDraws,
) -> torch.Tensor:
    """One optimizer step (JAX ``step_body``, cli/sparse_diffusion.py:
    400-501) on a (B, S, H, W) token batch, on the device with no host
    read: updates ``state``'s tensors in place (not ``state.step``) and
    returns the packed (loss, grad norm, ok) float32 (3,) tensor."""
    model = state.model
    draws = local_rows(draws, state.mesh)  # the global batch's draws: this rank's rows
    b = batch_z.shape[0]
    k = model.num_classes
    shape = model.shape
    volume = shape[0] * shape[1] * shape[2]
    if cfg.uniform_noise:
        r = uniform_sample(b, uniforms=draws.jitter)
    else:
        r = loss_aware_sample(state.sampler, b, gumbel=draws.gumbel,
                              jitter=draws.jitter)
    if cfg.sampling_type == "uniform":
        indices = sample_flat_positions(
            b, cfg.num_context, volume, uniforms=draws.position_uniform)
    else:
        indices = sample_time_dependent(
            b, cfg.num_context, shape, r, offset_uniform=draws.offset_uniform,
            uniforms=draws.position_uniform)
    target = torch.gather(batch_z.reshape(b, -1), 1, indices)
    corrupted, _ = corrupt_tokens(
        target, r, num_classes=k, mask_token=k,
        p_max_uniform=cfg.p_max_uniform,
        mask_uniform=draws.mask_uniform,
        resample_uniform=draws.resample_uniform,
        uniform_classes=draws.uniform_classes,
    )
    # the uniform sampler keeps no state (JAX skips its update)
    return ce_step(state, (corrupted, indices), target,
                   None if cfg.uniform_noise else r, cfg)


def train_step(
    state: TrainState,
    batch_z: torch.Tensor,
    cfg: SparseDiffusionConfig,
    draws: StepDraws,
) -> Tuple[float, float, bool]:
    """``step_body`` run eagerly, counted in ``state.step``, its (loss, grad
    norm, ok) read on the host."""
    stats = step_body(state, batch_z, cfg, draws)
    state.step += 1
    return as_row(stats.tolist())


def run_eval(
    model: VqSparseDiffusionModel,
    weights: Optional[Dict[str, torch.Tensor]],
    tok: Tokenizer,
    cfg: SparseDiffusionConfig,
    step: int,
    tag: str,
) -> Tuple[str, torch.Tensor, np.ndarray]:
    """The JAX ``run_eval`` (cli/sparse_diffusion.py:533-560): sample
    ``eval_batch_size`` volumes with ``num_eval_iterations`` sweeps of the
    model (with ``weights``, e.g. the EMA's, in place of its own when
    given; f32, eval mode), decode them and write the PNG grid (and, with
    ``save_frames``, one grid per frame). Returns (the grid's path, the
    token volume, the frames)."""
    was_training = model.training
    model.eval()
    try:
        if weights is None:
            logits_fn = model
        else:
            def logits_fn(toks, idx):
                return torch.func.functional_call(model, weights, (toks, idx))
        vol = sparse_denoise_volume(
            logits_fn,
            batch_size=cfg.eval_batch_size,
            shape=model.shape,
            num_classes=model.num_classes,
            mask_token=model.num_classes,
            num_context=cfg.num_context,
            num_iterations=cfg.num_eval_iterations,
            sampling_type=cfg.sampling_type,
            generator=torch.Generator(device=model.device).manual_seed(step),
        )
    finally:
        model.train(was_training)
    frames = decode_volume(tok, vol)
    path = os.path.join(cfg.output_dir, f"{cfg.name}_eval_{step:07d}_{tag}.png")
    save_image(make_grid(frames.reshape(-1, *frames.shape[2:]), nrow=cfg.S), path)
    if cfg.save_frames:
        for i in range(frames.shape[1]):
            save_image(make_grid(frames[:, i]), os.path.join(
                cfg.output_dir, f"{cfg.name}_{tag}_frame_{i:03d}.png"))
    print("eval artifact:", path)
    return path, vol, frames


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    # per step: (step, loss, grad_norm, ok, host clock after the step)
    history: List[Tuple[int, float, float, bool, float]]
    rejected: int
    # per evaluation: (step, tag, PNG path, wall seconds)
    evals: List[Tuple[int, str, str, float]]
    # the step program (its graph's launches on the GPU), the timing report
    program: Optional[StepProgram] = None
    timing: Optional[Dict] = None


def train(cfg: SparseDiffusionConfig) -> TrainResult:
    """Train as the JAX ``train`` does; returns the final state, each
    step's (loss, grad norm, ok) and the evaluations written."""
    check_supported(cfg)
    device = platform_device(cfg.platform)
    if not cfg.decoder_model and not cfg.tokenizer:
        raise ValueError("--decoder_model (tokenizer checkpoint) is required")
    if cfg.checkpoint and cfg.init_from:
        raise ValueError("--checkpoint (full resume) and --init_from "
                         "(weights-only) are mutually exclusive")
    # the data axis: every process of a torchrun job, each its rows of the
    # global batch from a sampler seeded by (seed, rank); rank 0 alone
    # writes checkpoints, logs, evaluations and the timing report
    initialize_distributed(device=device)
    device = process_device(device)
    mesh = make_mesh(n_model=cfg.n_model, n_pipe=cfg.n_pipe)
    local_batch = check_batch(cfg.batch_size, mesh)
    lead = mesh.lead
    torch.manual_seed(cfg.manual_seed)
    os.makedirs(cfg.output_dir, exist_ok=True)

    if cfg.tokenizer:
        tok = make_tokenizer(cfg.tokenizer, device)
    else:
        tok, _ = load_tokenizer(cfg.decoder_model, device)
    num_embeddings = tok.num_embeddings
    shape = (cfg.S, cfg.H, cfg.W)
    volume = cfg.S * cfg.H * cfg.W

    model = make_model(cfg, num_embeddings, device)
    print(f"parameters: {sum(p.numel() for p in model.parameters()):,}")
    # under the model axes rank 0 evaluates a plain model on the gathered
    # weights, as JAX's evaluation runs the unsharded module
    axes = mesh.n_model > 1 or mesh.n_pipe > 1
    eval_model = make_model(cfg, num_embeddings, device) if axes and lead else model
    state = init_state(cfg, model, mesh)
    lr_of = host_schedule(state.optimizer.schedule)
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

    config = config_to_dict(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.manual_seed)
    n_buckets = state.sampler.weights.shape[0]
    kdisp = max(1, cfg.steps_per_dispatch)
    sampler = build_sampler(dataclasses.replace(cfg, batch_size=local_batch),
                            rank_seed(cfg.manual_seed, mesh.rank))
    if cfg.checkpoint:
        restore_pipeline(sampler, cfg.checkpoint)
    batches = PrefetchIterator(
        lambda: sampler.sample_batch(local_batch), depth=2, device=device,
        # a Grain position rides the queue with its batch
        state_fn=getattr(sampler, "get_state", None))
    logger = rank_logger(mesh.process, cfg.output_dir, cfg.name, use_wandb=cfg.wandb,
                         project=cfg.project, config=config, tags=cfg.tags)
    saver = AsyncCheckpointSaver()
    # the port reads every step's ok flag, so the guard counts steps (the
    # JAX trainer samples the flag at log points)
    guard = CheckpointGuard(checkpoint_restorer(saver, state, cfg))
    tm = TrainTiming(probe_interval=cfg.probe_interval if cfg.timing_report else 0)
    history: List[Tuple[int, float, float, bool, float]] = []
    evals: List[Tuple[int, str, str, float]] = []
    rejected = 0
    io = step_inputs({"batch_z": torch.zeros((local_batch, *shape), dtype=torch.long,
                                             device=device)},
                     StepDraws.empty(cfg.batch_size, cfg.num_context, volume, n_buckets,
                                     device), kdisp)
    program = step_program(state, io, lambda: step_body(
        state, io.tensors["batch_z"], cfg, io.draws))
    seen_sizes = set()  # dispatch lengths already run
    intervals = [cfg.log_interval, cfg.histogram_interval, cfg.checkpoint_interval,
                 cfg.eval_interval, tm.probe_interval]
    if not cfg.single_batch:  # a dispatch ends where the batch changes
        intervals.append(cfg.change_batch_interval)
    have_batch = False

    def feed():
        draw_step(gen, cfg.batch_size, cfg.num_context, volume, n_buckets,
                  num_embeddings, out=io.draws)

    t0 = time.time()
    try:
        while state.step < cfg.max_steps:
            step = state.step
            # a fresh batch at steps 0, k, 2k, ... (k = change_batch_interval;
            # JAX's test (step + 1) % k == 1, which with k = 1 never refreshes)
            if not have_batch or (
                    not cfg.single_batch
                    and (step + 1) % cfg.change_batch_interval == 1):
                tt = time.perf_counter()
                io.tensors["batch_z"].copy_(encode_batch(tok, next(batches), shape))
                tm.add("data", time.perf_counter() - tt)
                have_batch = True
                if cfg.single_batch and step == 0 and lead:
                    gt = decode_volume(tok, io.tensors["batch_z"])
                    save_image(make_grid(gt.reshape(-1, *gt.shape[2:]), nrow=cfg.S),
                               os.path.join(cfg.output_dir, "gt.png"))
            n = dispatch_len(step, kdisp, cfg.max_steps, start_step + 1, intervals)
            rows = run_dispatch(program, io, tm, step, [feed] * n,
                                io.tensors["batch_z"], seen_sizes)
            rejected += record_steps(history, guard, rows, step, cfg, state)
            step += n
            if step % cfg.log_interval == 0 or step == start_step + 1:
                t0 = log_point(logger, tm, rows[-1], step, lr_of(step), cfg, t0,
                               start_step, kdisp, seen_sizes)
            if (cfg.histogram_interval and not cfg.uniform_noise
                    and step % cfg.histogram_interval == 0):
                logger.log_histogram(step, "sampler_weights",
                                     loss_aware_weights(state.sampler))
            if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                tt = time.perf_counter()
                whole = state.state_dict()  # gathered under --fsdp: every rank
                if lead:
                    path = saver.save(cfg.output_dir, step, whole, config,
                                      pipeline_files(batches.consumed_state()))
                    print("checkpoint:", path)
                tm.add("checkpoint", time.perf_counter() - tt)
            if cfg.eval_interval and step % cfg.eval_interval == 0:
                # gathered under --fsdp and the model axes: every rank
                ema = state.ema_weights()
                base = state.whole_params() if axes else None
                for tag, weights in (("base", base), ("ema", ema)):
                    if (tag == "ema" and weights is None) or not lead:
                        continue
                    te = time.perf_counter()
                    path, _, _ = run_eval(eval_model, weights, tok, cfg, step, tag)
                    evals.append((step, tag, path, time.perf_counter() - te))
                    tm.add("eval", time.perf_counter() - te)
    finally:
        try:
            saver.wait()  # the last save must land before exit
        finally:
            report = (write_timing(tm, cfg, batches, {
                "num_context": cfg.num_context, "num_classes": num_embeddings}, config)
                if lead else None)
            batches.close()
            sampler.close()
            logger.close()
    return TrainResult(state, history, rejected, evals, program, report)


def main(argv=None):
    cfg = dataclass_cli(SparseDiffusionConfig, argv)
    print("Config:", cfg)
    train(cfg)


if __name__ == "__main__":
    main()
