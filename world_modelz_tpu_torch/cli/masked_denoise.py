"""Masked-denoise prototype: a gMLP over patch-VQ tokens.

Port of ``world_modelz_tpu.cli.masked_denoise`` (reference:
vq-video-diffusion/masked_denoise_prototype/main.py): (1) fit a patch
vector quantizer (an EMA quantizer over flattened p x p x 3 patch vectors
of one pyramid level, ``fit_patch_vq``), then (2) train a gMLP
(``models.gmlp``) to denoise masked token grids of that level, with the
named cosine-power noise schedules (``diffusion.schedules``), the
VQ-embedding input with a zero mask embedding (``ops.vq.vq_decode_masked``),
an iterative-unmask evaluation written as a denoising-trace PNG, and a
log-scale loss plot (matplotlib; "skipped" without it).

The patch quantizer's route is chosen once from D = 3 p^2 and printed: for
D <= 64 (``kernels.vq_kernels.MAX_D``) the step's encode runs the
``vq_encode_nearest`` kernel and the fit runs ``ops.vq.vq_apply_fused`` (the
``vq_train_stats`` kernel); above, the plain distance product (``ops.vq``),
as the JAX trainer's XLA path computes it. On the CPU the kernel wrappers
run their plain versions.

The step (``step_body``) is one function of device tensors with no host
read: the five draws of a step (``StepDraws``: r, the mask, the resampling,
the uniform classes and the second r of ``--independent_uniform``) come
from an explicit generator into static buffers, so a test can feed JAX's;
AdamW under ``exponential_decay(lr, 25000, 0.5, staircase=True)``, the
global grad norm and the ``--nan_guard`` select run on the device. On the
CPU it runs eagerly, on the GPU as a CUDA graph (``train.dispatch.
StepProgram``). The loss is read at log points and once at the end.

Checkpoints hold ``params``, ``vq`` and ``opt_state`` (every
``checkpoint_interval`` steps, written in the background); the guard
(``train.guard.CheckpointGuard``) reloads the newest one after a streak of
rejected steps. Images are in [-1, 1], as the reference's SetRange.

Run (the GPU by default, ``--platform cpu`` for the CPU):

    python -m world_modelz_tpu_torch.cli.masked_denoise --output_dir md
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from world_modelz_tpu_torch._device import platform_device
from world_modelz_tpu_torch.cli.video_diffusion import gumbel_
from world_modelz_tpu_torch.data import (
    FileListImageDataset,
    SyntheticTrajectorySource,
    load_file_list,
)
from world_modelz_tpu_torch.diffusion.masked import top_k_logits
from world_modelz_tpu_torch.diffusion.schedules import named_schedule
from world_modelz_tpu_torch.kernels.vq_kernels import MAX_D, vq_encode_nearest
from world_modelz_tpu_torch.models.gmlp import GMLP
from world_modelz_tpu_torch.ops.vq import (
    VQState,
    vq_apply,
    vq_apply_fused,
    vq_decode,
    vq_decode_masked,
    vq_encode,
    vq_init,
)
from world_modelz_tpu_torch.train import (
    AsyncCheckpointSaver,
    CheckpointGuard,
    ScheduledOptimizer,
    latest_checkpoint,
    make_optimizer,
    reject_nonfinite,
    restore_checkpoint,
    step_decay_schedule,
)
from world_modelz_tpu_torch.train.dispatch import StepInputs, StepProgram, step_inputs
from world_modelz_tpu_torch.utils.config import config_to_dict, dataclass_cli
from world_modelz_tpu_torch.utils.image import make_grid, save_image
from world_modelz_tpu_torch.utils.logging import MetricLogger


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C) patch vectors (the reference's
    Rearrange 'b c (h p1) (w p2) -> b (h w) c p1 p2', main.py:186)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def unpatchify(patches: torch.Tensor, patch: int, grid: int, c: int = 3) -> torch.Tensor:
    """(B, N, patch*patch*C) -> (B, H, W, C)."""
    b = patches.shape[0]
    x = patches.reshape(b, grid, grid, patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid * patch, grid * patch, c)


@dataclasses.dataclass
class MaskedDenoiseConfig:
    """Mirrors the hard-coded config block (main.py:153-165) as flags, with
    the JAX package's field names and defaults."""

    manual_seed: int = 0
    platform: str = ""  # "" = the GPU (raises without one), "cpu"
    batch_size: int = 14
    lr: float = 5e-4
    weight_decay: float = 1e-7
    nan_guard: bool = True  # reject non-finite steps; auto-restore on streaks
    d_model: int = 512
    depth: int = 5
    schedule_name: str = "cos3_inv"
    level: int = 5  # pyramid level: patch = image_size / 2^level
    p_max_uniform: float = 0.1
    independent_uniform: bool = False
    codebook_size: int = 256

    image_size: int = 64
    dataset: str = "synthetic"  # synthetic|files
    file_list_fn: str = "file_list.json"
    image_dir_path: str = ""
    image_fn_regex: str = r".*\.(png|jpg)$"

    vq_steps: int = 300  # patch-VQ fitting steps
    max_steps: int = 10000
    eval_interval: int = 1000
    eval_batch_size: int = 24
    num_eval_iterations: int = 25
    sample_topk: int = -1
    checkpoint_interval: int = 5000
    log_interval: int = 10

    name: str = "masked_denoise"
    output_dir: str = "outputs/masked_denoise"
    wandb: bool = False  # without the wandb package: JSONL only
    project: str = "masked_denoise"
    tags: str = ""


def _batch_fn(cfg: MaskedDenoiseConfig, seed: int) -> Callable[..., np.ndarray]:
    """Host source of (n or batch_size, H, W, 3) float32 images in [-1, 1]:
    the image files, or frames of 32 synthetic trajectories drawn by
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    if cfg.dataset == "files":
        files = load_file_list(cfg.file_list_fn, cfg.image_dir_path, cfg.image_fn_regex)
        ds = FileListImageDataset(files, cfg.batch_size, seed=seed)
        return lambda n=None: ds.next_batch() * 2.0 - 1.0
    if cfg.dataset != "synthetic":
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    src = SyntheticTrajectorySource(
        num_trajectories=32, traj_frames=64, frame_size=cfg.image_size, seed=seed)
    frames = np.concatenate(
        [np.stack(list(src.load_frames(n))) for n in src.trajectory_names()]
    ).astype(np.float32) / 127.5 - 1.0

    def sample(n=None):
        return frames[rng.integers(0, len(frames), n or cfg.batch_size)]

    return sample


def vq_route(d: int) -> str:
    """The patch quantizer's route for patch vectors of width ``d``:
    "kernel" (the VQ kernels' wrappers) when they take it, else "plain"
    (the distance product of ``ops.vq``)."""
    return "kernel" if d <= MAX_D else "plain"


def describe_route(route: str, d: int) -> str:
    if route == "kernel":
        return f"patch VQ: kernel vq_encode/vq_train_stats (D={d})"
    return f"patch VQ: plain distance product (D={d} > {MAX_D})"


def fit_patch_vq(cfg: MaskedDenoiseConfig, batch_fn, patch: int, state: VQState,
                 route: Optional[str] = None) -> VQState:
    """Fit the EMA quantizer from ``state`` on the patch vectors of
    ``vq_steps`` batches (``train_vq_models``): ``vq_apply_fused`` on the
    kernel route, ``vq_apply`` on the plain one."""
    d = 3 * patch * patch
    apply = vq_apply_fused if (route or vq_route(d)) == "kernel" else vq_apply
    device = state.codebook.device
    out = None
    for _ in range(cfg.vq_steps):
        images = torch.from_numpy(np.ascontiguousarray(batch_fn())).to(device)
        vecs = patchify(images, patch).reshape(-1, 1, d)
        out, state = apply(state, vecs, train=True)
    if out is not None:
        print(f"patch VQ fitted: patch={patch} perplexity={float(out.perplexity):.1f}")
    return state


def encode_patches(codebook: torch.Tensor, vecs: torch.Tensor, route: str) -> torch.Tensor:
    """Nearest-code indices (N,) of (N, D) patch vectors."""
    if route == "kernel":
        return vq_encode_nearest(vecs.contiguous(), codebook[0].contiguous())
    return vq_encode(codebook, vecs[:, None, :])[:, 0]


@dataclasses.dataclass
class StepDraws:
    """The random numbers of one step (JAX splits its step key five ways)."""

    r: torch.Tensor  # (B, 1) uniforms the schedule warps into r
    mask_uniform: torch.Tensor  # (B, N) mask where < r
    resample_uniform: torch.Tensor  # (B, N) resample where < r' p_max_uniform
    uniform_classes: torch.Tensor  # (B, N) resampled class ids
    r2: torch.Tensor  # (B, 1) r' of --independent_uniform

    @classmethod
    def empty(cls, b: int, n: int, device) -> "StepDraws":
        def f(*shape):
            return torch.empty(shape, device=device)

        return cls(f(b, 1), f(b, n), f(b, n),
                   torch.empty((b, n), dtype=torch.long, device=device), f(b, 1))


def draw_step(generator: torch.Generator, b: int, n: int, num_classes: int,
              out: Optional[StepDraws] = None) -> StepDraws:
    """One step's draws for ``b`` grids of ``n`` tokens, from ``generator``
    (on its device), into ``out``'s tensors when given."""
    if out is None:
        out = StepDraws.empty(b, n, generator.device)
    for t in (out.r, out.mask_uniform, out.resample_uniform):
        torch.rand(t.shape, generator=generator, out=t)
    torch.randint(0, num_classes, (b, n), generator=generator, out=out.uniform_classes)
    torch.rand(out.r2.shape, generator=generator, out=out.r2)
    return out


@dataclasses.dataclass
class Task:
    """What the step needs besides its inputs: the shapes, the frozen patch
    quantizer's codebook and its route, and the schedule."""

    patch: int
    grid: int
    codebook: torch.Tensor  # (1, K, D)
    route: str
    schedule: Callable[[torch.Tensor], torch.Tensor]

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid

    @property
    def num_tokens(self) -> int:
        return self.codebook.shape[1]

    @property
    def d_patch(self) -> int:
        return self.codebook.shape[2]


def make_task(cfg: MaskedDenoiseConfig, vq_state: VQState, route: str) -> Task:
    patch = cfg.image_size // (2 ** cfg.level)
    return Task(patch, cfg.image_size // patch, vq_state.codebook, route,
                named_schedule(cfg.schedule_name))


def make_model(cfg: MaskedDenoiseConfig, task: Task, device=None) -> GMLP:
    return GMLP(num_tokens_in=task.num_tokens + 1, num_tokens_out=task.num_tokens,
                dim=cfg.d_model, depth=cfg.depth, seq_len=task.seq_len,
                vq_embedding_dim=task.d_patch, device=device)


def make_denoise_optimizer(cfg: MaskedDenoiseConfig, model: GMLP) -> ScheduledOptimizer:
    """AdamW under optax.exponential_decay(lr, 25000, 0.5, staircase=True)."""
    return make_optimizer("adamw", model.parameters(),
                          step_decay_schedule(cfg.lr, 25000, 1, 0.5), cfg.weight_decay)


def corrupt(cfg: MaskedDenoiseConfig, task: Task, encoding: torch.Tensor,
            draws: StepDraws) -> torch.Tensor:
    """The step's input tokens: masked where the uniform is < r, else
    resampled uniformly where another is < r' p_max_uniform."""
    mask_token = task.num_tokens
    r = task.schedule(draws.r)
    mask = draws.mask_uniform < r
    r_pert = draws.r2 if cfg.independent_uniform else r
    resample = draws.resample_uniform < r_pert * cfg.p_max_uniform
    draw = torch.where(resample, draws.uniform_classes, encoding)
    return torch.where(mask, mask_token, draw)


def step_body(model: GMLP, opt: ScheduledOptimizer, task: Task, images: torch.Tensor,
              draws: StepDraws, cfg: MaskedDenoiseConfig) -> torch.Tensor:
    """One optimizer step (JAX ``train_step``, cli/masked_denoise.py:195-243)
    on (B, H, W, 3) images in [-1, 1], on the device with no host read:
    updates the parameters and the optimizer in place and returns the
    packed (loss, grad norm, ok) float32 (3,) tensor."""
    b = images.shape[0]
    n, d = task.seq_len, task.d_patch
    vecs = patchify(images, task.patch).reshape(-1, d)
    encoding = encode_patches(task.codebook, vecs, task.route).long().reshape(b, n)
    inp = corrupt(cfg, task, encoding, draws)
    vq_embedding = vq_decode_masked(task.codebook, inp[..., None], task.num_tokens)
    opt.zero_grad()
    logits = model(inp, vq_embedding.reshape(b, n, d))
    loss = F.cross_entropy(logits.reshape(-1, task.num_tokens).float(), encoding.reshape(-1))
    loss.backward()
    with torch.no_grad():
        loss = loss.detach()
        g = opt.flat_grad()
        gn = torch.linalg.vector_norm(g)
        ok = torch.isfinite(loss) & torch.isfinite(gn)
        new = opt.propose(g)
        if cfg.nan_guard:
            new = reject_nonfinite(ok, opt.state_tensors(), new)
        opt.assign(new)
        return torch.stack([loss.float(), gn, ok.to(torch.float32)])


@torch.no_grad()
def evaluate(cfg: MaskedDenoiseConfig, model: GMLP, task: Task, step: int) -> str:
    """Iterative unmask with a per-iteration decode trace (main.py:229-296):
    each iteration draws every token from the logits (top-k with
    ``sample_topk``), keeps a fraction f^2 of them (f = (i + 1) / n), decodes
    the draw into the trace and feeds the kept tokens back. Writes the
    trace grid (one row an iteration) and returns its path."""
    b, n, k = cfg.eval_batch_size, task.seq_len, task.num_tokens
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(step)
    logits = torch.zeros((b, n, k), device=dev)
    traces = []
    was_training = model.training
    model.eval()
    try:
        for i in range(cfg.num_eval_iterations):
            lg = logits.reshape(-1, k)
            if cfg.sample_topk > 0:
                lg = top_k_logits(lg, cfg.sample_topk)
            gumbel = gumbel_(torch.rand(lg.shape, generator=gen, device=dev))
            denoised = (lg + gumbel).argmax(-1).reshape(b, n)
            frac = (i + 1) / cfg.num_eval_iterations
            alpha = min(frac ** 2, 1.0)  # eval_noise_schedule (main.py:130)
            mask = torch.rand((b, n), generator=gen, device=dev) > alpha
            sample = torch.where(mask, task.num_tokens, denoised)
            dec = vq_decode(task.codebook, denoised[..., None]).reshape(b, n, task.d_patch)
            traces.append(((unpatchify(dec, task.patch, task.grid) + 1.0) * 0.5)
                          .float().cpu().numpy())
            emb = vq_decode_masked(task.codebook, sample[..., None], task.num_tokens)
            logits = model(sample, emb.reshape(b, n, task.d_patch)).float()
    finally:
        model.train(was_training)
    os.makedirs(cfg.output_dir, exist_ok=True)
    fn = os.path.join(cfg.output_dir, f"{cfg.name}_eval_{step:07d}.png")
    save_image(make_grid(np.concatenate(traces), nrow=b), fn)
    print("eval artifact:", fn)
    return fn


@dataclasses.dataclass
class TrainResult:
    model: GMLP
    vq: VQState
    optimizer: ScheduledOptimizer
    task: Task
    losses: List[float]  # every step's loss
    evals: List[str]  # the trace PNGs written
    program: StepProgram
    # the guard's escalation: reload the newest checkpoint's params and
    # optimizer state in place; returns its path (None without one)
    restore_latest: Callable[[], Optional[str]]


def vq_state_dict(state: VQState) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def train(cfg: MaskedDenoiseConfig) -> TrainResult:
    """Fit the patch quantizer, then train the gMLP as the JAX ``train``
    does; returns the model, the quantizer and every step's loss."""
    device = platform_device(cfg.platform)
    patch = cfg.image_size // (2 ** cfg.level)
    d_patch = 3 * patch * patch
    route = vq_route(d_patch)
    print(describe_route(route, d_patch))
    torch.manual_seed(cfg.manual_seed)
    gen = torch.Generator(device=device).manual_seed(cfg.manual_seed)
    batch_fn = _batch_fn(cfg, cfg.manual_seed)

    init = vq_init(1, cfg.codebook_size, d_patch, generator=gen, device=device)
    vq_state = fit_patch_vq(cfg, batch_fn, patch, init, route)
    task = make_task(cfg, vq_state, route)
    model = make_model(cfg, task, device).train()
    print(f"parameters: {sum(p.numel() for p in model.parameters()):,}")
    opt = make_denoise_optimizer(cfg, model)

    io: StepInputs = step_inputs(
        {"images": torch.zeros((cfg.batch_size, cfg.image_size, cfg.image_size, 3),
                               device=device)},
        StepDraws.empty(cfg.batch_size, task.seq_len, device), 1)

    def body():
        io.record(step_body(model, opt, task, io.tensors["images"], io.draws, cfg))

    program = StepProgram(body, device, keep=lambda: list(opt.state_tensors().values())
                          + [io.stats, io.row], inputs=io)
    config = config_to_dict(cfg)
    logger = MetricLogger(cfg.output_dir, cfg.name, use_wandb=cfg.wandb,
                          project=cfg.project, config=config, tags=cfg.tags)
    saver = AsyncCheckpointSaver()

    def restore_latest() -> Optional[str]:
        saver.wait()  # an in-flight save must land first
        path = latest_checkpoint(cfg.output_dir)
        if not path:
            return None
        restored, at_step, _ = restore_checkpoint(path)
        model.load_state_dict(restored["params"], strict=True)
        opt.load_state_dict(restored["opt_state"])
        print(f"[guard] restored {path} (step {at_step})")
        return path

    guard = CheckpointGuard(restore_latest)
    loss_log: List[torch.Tensor] = []  # device scalars, read once at the end
    evals: List[str] = []
    t0 = time.time()
    try:
        for step in range(1, cfg.max_steps + 1):
            io.tensors["images"].copy_(torch.from_numpy(np.ascontiguousarray(batch_fn())))
            draw_step(gen, cfg.batch_size, task.seq_len, task.num_tokens, out=io.draws)
            io.start()
            program()
            loss_log.append(io.stats[0, 0].clone())
            if step % cfg.log_interval == 0 or step == 1:
                loss, gn, ok = io.stats[0].tolist()
                accepted = ok > 0.5 or not cfg.nan_guard
                if not accepted:
                    print(f"{step}: step REJECTED (non-finite loss/grads)")
                guard.record(accepted, step)
                dt, t0 = time.time() - t0, time.time()
                logger.log(step, loss=loss, grad_norm=gn,
                           steps_per_sec=cfg.log_interval / max(dt, 1e-9))
                print(f"{step}: loss {loss:.4f}")
            if cfg.eval_interval and step % cfg.eval_interval == 0:
                evals.append(evaluate(cfg, model, task, step))
            if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                path = saver.save(cfg.output_dir, step, {
                    "params": model.state_dict(), "vq": vq_state_dict(vq_state),
                    "opt_state": opt.state_dict()}, config)
                print("checkpoint:", path)
        losses = torch.stack(loss_log).tolist() if loss_log else []
        _plot_loss(cfg, losses)
    finally:
        try:
            saver.wait()  # the last save must land before exit
        except Exception as e:
            print("[checkpoint] async save failed:", e)
        logger.close()
    return TrainResult(model, vq_state, opt, task, losses, evals, program, restore_latest)


def _plot_loss(cfg: MaskedDenoiseConfig, loss_log: List[float]) -> None:
    """Log-scale CE curve (main.py:300-321); skipped without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        ax.plot(loss_log)
        ax.set_yscale("log")
        ax.set_title("Cross Entropy")
        ax.set_xlabel("iteration")
        os.makedirs(cfg.output_dir, exist_ok=True)
        fig.savefig(f"{cfg.output_dir}/{cfg.name}_plot.png", format="png")
        plt.close(fig)
    except Exception as e:
        print("loss plot skipped:", e)


def main(argv=None):
    cfg = dataclass_cli(MaskedDenoiseConfig, argv)
    print("Config:", cfg)
    train(cfg)


if __name__ == "__main__":
    main()
