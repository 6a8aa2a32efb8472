"""The SOM-DDPM pipeline: five stages coupled through checkpoints.

Port of ``world_modelz_tpu.cli.som_pipeline`` (the reference's manual
pipeline, som-diffusion/experiments/ds2/README.md):

1. ``train_ae``: the conv autoencoder without the SOM (train_ae.py);
2. ``train_som``: the SOM fitted to the frozen autoencoder's latents by
   ``som_adapt``, eta decaying linearly and sigma exponentially
   (train_som.py:57-129), optionally resized first (:168-173);
3. ``finetune_ae``: the autoencoder trained through the SOM
   (straight-through, ``latent_loss_weight`` times its difference), the SOM
   adapted every ``som_adapt_skip + 1`` steps (finetune_ae.py:167-240);
4. ``create_diffusion_dataset``: the images encoded to an ``.npz`` of
   (N, h, w, 2) SOM coordinates in [-1, 1] (create_diffusion_dataset.py:
   73-97);
5. ``train_diffusion``: the UNet eps-prediction DDPM on those latents
   (cosine alpha-bar, AdamW with warmup and cosine decay, EMA,
   accumulation), evaluated by x0-reprojection samples decoded through the
   SOM autoencoder (train_diffusion.py:79-172).

Each stage has JAX's config dataclass (fields and defaults) and a
``main_*`` entry point; a checkpoint embeds its config (with the SOM's
size), so the next stage rebuilds the model from it. The data is
``--dataset synthetic`` (frames of the synthetic trajectories) or
``files`` (the images under ``--image_dir_path``, ``data.images``). Every
step runs on the device and reads nothing on the host: the guard's
select of the old or new state (``--nan_guard``) is made there, and the
host reads a step's loss and ok flag at log points only, as JAX does.
``--platform`` is ``""`` (the GPU; raises without one) or ``"cpu"``.

Run a stage (the GPU by default):

    python -m world_modelz_tpu_torch.cli.som_pipeline train_ae \\
        --output_dir outputs/som_ae
    python -m world_modelz_tpu_torch.cli.som_pipeline train_som \\
        --ae_checkpoint outputs/som_ae/step_0010000 --output_dir outputs/som
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from world_modelz_tpu_torch._device import platform_device
from world_modelz_tpu_torch.data import (
    FileListImageDataset,
    PrefetchIterator,
    SyntheticTrajectorySource,
    load_file_list,
)
from world_modelz_tpu_torch.diffusion.ddpm import ddpm_corrupt, ddpm_sample
from world_modelz_tpu_torch.models.som_autoencoder import SomAutoEncoder, SomTokenizerState
from world_modelz_tpu_torch.models.unet import UNetDiffusionModel
from world_modelz_tpu_torch.ops.som import SomState, som_adapt
from world_modelz_tpu_torch.train import (
    CheckpointGuard,
    host_schedule,
    latest_checkpoint,
    make_optimizer,
    reject_nonfinite,
    restore_checkpoint,
    save_checkpoint,
    step_decay_schedule,
)
from world_modelz_tpu_torch.utils.config import config_from_dict, config_to_dict, dataclass_cli
from world_modelz_tpu_torch.utils.image import make_grid, save_image
from world_modelz_tpu_torch.utils.logging import MetricLogger


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def image_batch_fn(dataset: str, file_list_fn: str, image_dir_path: str, image_fn_regex: str,
                   batch_size: int, image_size: int, seed: int) -> Callable[[], np.ndarray]:
    """A (B, H, W, 3) float32 [0, 1] batch source (JAX's
    ``_image_batch_fn``): image files, or random frames of 32 synthetic
    trajectories of 64 frames."""
    rng = np.random.default_rng(seed)
    if dataset == "files":
        files = load_file_list(file_list_fn, image_dir_path, image_fn_regex)
        return FileListImageDataset(files, batch_size, seed=seed).next_batch
    if dataset != "synthetic":
        raise ValueError(f"--dataset must be 'synthetic' or 'files', got {dataset!r}")
    src = SyntheticTrajectorySource(num_trajectories=32, traj_frames=64,
                                    frame_size=image_size, seed=seed)
    frames = np.concatenate(
        [np.stack(list(src.load_frames(n))) for n in src.trajectory_names()]
    ).astype(np.float32) / 255.0

    def sample():
        return frames[rng.integers(0, len(frames), batch_size)]

    return sample


def _batches(cfg, device) -> PrefetchIterator:
    return PrefetchIterator(
        image_batch_fn(cfg.dataset, cfg.file_list_fn, cfg.image_dir_path, cfg.image_fn_regex,
                       cfg.batch_size, cfg.image_size, cfg.manual_seed),
        depth=2, device=device)


def _recon_loss(kind: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    kind = kind.lower()
    if kind in ("mae", "l1"):
        return F.l1_loss
    if kind == "mse":
        return F.mse_loss
    return lambda a, b: F.huber_loss(a, b, delta=1.0)  # optax.huber_loss, delta 1


def _som_dict(som: SomState) -> Dict[str, torch.Tensor]:
    return {"embedding": som.embedding, "activation_count": som.activation_count}


def load_som_ae(path: str, pass_through: bool = True, device=None
                ) -> Tuple[SomAutoEncoder, Dict]:
    """Rebuild a SomAutoEncoder from a checkpoint of any stage of the
    first three (its embedded config); returns (the autoencoder, the
    config)."""
    state, _step, config = restore_checkpoint(path)
    ae_cfg = config_from_dict(TrainAeConfig, config)
    width = int(config.get("som_width") or 128)
    height = int(config.get("som_height") or 128)
    ae = SomAutoEncoder(ae_cfg.embedding_dim, ae_cfg.downscale_steps, ae_cfg.hidden_planes,
                        som_width=1, som_height=1, pass_through_som=pass_through,
                        device=device)
    raw = state["ae"]
    ae.load_tokenizer_state(SomTokenizerState(raw["state_dict"], SomState(
        raw["som"]["embedding"], raw["som"]["activation_count"], width, height)))
    return ae, config


def _save_ae(cfg, step: int, ae: SomAutoEncoder, extra: Optional[Dict] = None) -> str:
    payload = {"ae": {"state_dict": ae.state_dict(), "som": _som_dict(ae.som)}}
    payload.update(extra or {})
    config = config_to_dict(cfg)
    config["som_width"], config["som_height"] = ae.som_width, ae.som_height
    return save_checkpoint(cfg.output_dir, step, payload, config)


def _carrier(cfg, ae: SomAutoEncoder) -> "TrainAeConfig":
    """The config a stage-2 or stage-3 checkpoint embeds: the autoencoder's
    geometry (JAX's ``cfg2_for_save``)."""
    return TrainAeConfig(embedding_dim=ae.embedding_dim, downscale_steps=ae.downscale_steps,
                         hidden_planes=ae.hidden_planes, output_dir=cfg.output_dir,
                         name=cfg.name)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class StageResult:
    model: torch.nn.Module  # the SomAutoEncoder, or the UNet (train_diffusion)
    path: str  # the stage's final checkpoint
    # one dict a log point: step, the logged values, ok
    history: List[Dict[str, float]]
    # steps 2..max_steps, the device synchronized, without checkpoints and
    # evaluations
    steps_per_sec: float


class _Clock:
    """steps/s over steps 2..n (the first step's warm-up left out), without
    the time spent in ``aside()`` blocks (checkpoints, images, evaluation)."""

    def __init__(self, device):
        self.device, self.t1, self.away = device, None, 0.0

    def first_done(self) -> None:
        _sync(self.device)
        self.t1 = time.perf_counter()

    @contextlib.contextmanager
    def aside(self):
        _sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(self.device)
            self.away += time.perf_counter() - t0

    def rate(self, steps: int) -> float:
        _sync(self.device)
        if self.t1 is None or steps < 2:
            return float("nan")
        return (steps - 1) / max(time.perf_counter() - self.t1 - self.away, 1e-9)


@torch.no_grad()
def _guarded_update(opt, proposal: Dict, ok: torch.Tensor, nan_guard: bool,
                    old: Dict, new: Dict) -> Dict:
    """The optimizer's ``proposal`` joined to ``new`` (the step's other
    tensors), with ``old``'s kept where ``ok`` is False under
    ``nan_guard``; writes the optimizer's buffers and returns the rest."""
    old = dict(old, opt=opt.state_tensors())
    new = dict(new, opt=proposal)
    if nan_guard:
        new = reject_nonfinite(ok, old, new)
    opt.assign(new.pop("opt"))
    return new


# ---------------------------------------------------------------------------
# stage 1: train_ae
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainAeConfig:
    """Flags mirror som-diffusion/train_ae.py:34-60."""

    manual_seed: int = 0
    platform: str = ""  # "" = the GPU (raises without one), "cpu"
    batch_size: int = 96
    optimizer: str = "AdamW"
    lr: float = 2e-4
    loss_fn: str = "SmoothL1"
    nan_guard: bool = True  # reject non-finite steps; restore on streaks
    max_steps: int = 10000
    lr_decay_interval: int = 3000

    downscale_steps: int = 3
    embedding_dim: int = 64
    hidden_planes: int = 128

    dataset: str = "synthetic"  # synthetic|files
    image_size: int = 64
    file_list_fn: str = "file_list.json"
    image_dir_path: str = ""
    image_fn_regex: str = r".*\.png$"

    checkpoint_interval: int = 2500
    log_interval: int = 50
    wandb: bool = False  # without the wandb package: JSONL only
    project: str = "som-diffusion"
    tags: str = ""
    name: str = "ae"
    output_dir: str = "outputs/som_ae"


def _ae_step(ae: SomAutoEncoder, opt, batch: torch.Tensor, loss_fn, nan_guard: bool,
             latent_loss_weight: float = 0.0,
             adapt: Optional[Tuple[float, float, int]] = None):
    """One autoencoder step on the device (JAX's ``step_fn`` of train_ae
    and finetune_ae): forward in training mode, backward, the optimizer's
    proposal; with ``adapt`` (rate, radius, chunk) the SOM adapted to the
    forward's latents; the old parameters, BatchNorm statistics and SOM kept
    where the loss, the grad norm (or the SOM's error) is not finite.
    Returns (loss, SOM error, reconstruction, ok) tensors."""
    buffers = list(ae.buffers())
    saved = [b.clone() for b in buffers]
    opt.zero_grad()
    recon, h_in, h_diff = ae(batch, train=True)
    loss = loss_fn(recon, batch)
    if h_diff is not None:
        loss = loss + latent_loss_weight * h_diff
    loss.backward()
    with torch.no_grad():
        loss = loss.detach()
        g = opt.flat_grad()
        ok = torch.isfinite(loss) & torch.isfinite(torch.linalg.vector_norm(g))
        som_err = torch.zeros((), device=batch.device)
        old = {"buffers": saved, "som": _som_dict(ae.som)}
        new = {"buffers": buffers, "som": _som_dict(ae.som)}
        if adapt is not None:
            som, som_err = som_adapt(ae.som, h_in.detach(), adapt[0], adapt[1],
                                     adapt_batch_size=adapt[2])
            new["som"] = _som_dict(som)
            ok = ok & torch.isfinite(som_err)
        new = _guarded_update(opt, opt.propose(g), ok, nan_guard, old, new)
        torch._foreach_copy_(buffers, new["buffers"])
        ae.som = ae.som.replace(**new["som"])
    return loss, som_err, recon.detach(), ok


def train_ae(cfg: TrainAeConfig) -> StageResult:
    device = platform_device(cfg.platform)
    torch.manual_seed(cfg.manual_seed)
    gen = torch.Generator(device=device).manual_seed(cfg.manual_seed)
    ae = SomAutoEncoder(cfg.embedding_dim, cfg.downscale_steps, cfg.hidden_planes,
                        generator=gen, device=device)
    loss_fn = _recon_loss(cfg.loss_fn)
    schedule = step_decay_schedule(cfg.lr, steps_per_epoch=cfg.lr_decay_interval,
                                   epoch_step_size=1)
    lr_of = host_schedule(schedule)
    opt = make_optimizer(cfg.optimizer, ae.parameters(), schedule)
    batches = _batches(cfg, device)
    logger = MetricLogger(cfg.output_dir, cfg.name, use_wandb=cfg.wandb, project=cfg.project,
                          config=config_to_dict(cfg), tags=cfg.tags)

    def restore_latest():
        path = latest_checkpoint(cfg.output_dir)
        if not path:
            return None
        loaded, _ = load_som_ae(path, pass_through=False, device=device)
        ae.load_tokenizer_state(loaded.tokenizer_state())
        opt.load_state_dict(restore_checkpoint(path)[0]["opt_state"])
        print(f"[guard] restored {path}")
        return path

    guard = CheckpointGuard(restore_latest)
    history: List[Dict[str, float]] = []
    clock = _Clock(device)
    try:
        for step in range(1, cfg.max_steps + 1):
            loss, _, recon, ok = _ae_step(ae, opt, next(batches), loss_fn, cfg.nan_guard)
            if step == 1:
                clock.first_done()
            if step % cfg.log_interval == 0 or step == 1:
                loss_v, ok_v = (float(v) for v in torch.stack([loss, ok.float()]).tolist())
                accepted = ok_v > 0.5 or not cfg.nan_guard
                if not accepted:
                    print(f"{step}: step REJECTED (non-finite loss/grads)")
                guard.record(accepted, step)
                logger.log(step, loss=loss_v, lr=lr_of(step))
                history.append(dict(step=step, loss=loss_v, ok=accepted))
                print(f"step {step}: loss {loss_v:.4f}")
            if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                with clock.aside():
                    path = _save_ae(cfg, step, ae, {"opt_state": opt.state_dict()})
                    save_image(recon[:16].float().cpu().numpy(), os.path.join(
                        cfg.output_dir, f"{cfg.name}_reconst_{step:07d}.png"))
                print("checkpoint:", path)
        rate = clock.rate(cfg.max_steps)
    finally:
        batches.close()
        logger.close()
    path = _save_ae(cfg, cfg.max_steps, ae, {"opt_state": opt.state_dict()})
    print("final checkpoint:", path)
    return StageResult(ae, path, history, rate)


# ---------------------------------------------------------------------------
# stage 2: train_som
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainSomConfig:
    """Flags mirror som-diffusion/train_som.py:20-54."""

    manual_seed: int = 42
    platform: str = ""
    batch_size: int = 96
    ae_checkpoint: str = ""

    som_width: int = 0  # 0 = keep the checkpoint's size
    som_height: int = 0
    adapt_batch_size: int = 32
    sigma_begin: float = 64.0
    sigma_end: float = 0.1
    eta_begin: float = 0.5
    eta_end: float = 0.05
    nan_guard: bool = True  # reject non-finite SOM adaption steps
    max_steps: int = 10000

    dataset: str = "synthetic"
    image_size: int = 64
    file_list_fn: str = "file_list.json"
    image_dir_path: str = ""
    image_fn_regex: str = r".*\.png$"

    checkpoint_interval: int = 2000
    log_interval: int = 25
    wandb: bool = False
    project: str = "som-diffusion"
    tags: str = ""
    name: str = "som"
    output_dir: str = "outputs/som"


def train_som(cfg: TrainSomConfig) -> StageResult:
    device = platform_device(cfg.platform)
    if not cfg.ae_checkpoint:
        raise ValueError("--ae_checkpoint is required")
    ae, _ = load_som_ae(cfg.ae_checkpoint, pass_through=True, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.manual_seed)
    if cfg.som_width or cfg.som_height:
        w = cfg.som_width or ae.som_width
        h = cfg.som_height or ae.som_height
        print(f"reinitializing SOM to {w}x{h}")
        ae.resize_som(w, h, generator=gen)
    exp_decay_scale = math.log(cfg.sigma_end / cfg.sigma_begin)
    batches = _batches(cfg, device)
    logger = MetricLogger(cfg.output_dir, cfg.name, use_wandb=cfg.wandb, project=cfg.project,
                          config=config_to_dict(cfg), tags=cfg.tags)
    history: List[Dict[str, float]] = []
    clock = _Clock(device)
    path = ""
    try:
        for step in range(1, cfg.max_steps + 1):
            progress = (step - 1) / cfg.max_steps
            eta = cfg.eta_begin * (1.0 - progress) + progress * cfg.eta_end  # :90
            sigma = cfg.sigma_begin * math.exp(progress * exp_decay_scale)  # :94
            batch = next(batches)
            with torch.no_grad():
                h = ae.encode_latent(batch)
                som, err = som_adapt(ae.som, h, eta, sigma, adapt_batch_size=cfg.adapt_batch_size)
                ok = torch.isfinite(err)
                if cfg.nan_guard:
                    som = ae.som.replace(**reject_nonfinite(ok, _som_dict(ae.som),
                                                            _som_dict(som)))
            ae.som = som
            if step == 1:
                clock.first_done()
            if step % cfg.log_interval == 0 or step == 1:
                err_v, ok_v = torch.stack([err, ok.float()]).tolist()
                if cfg.nan_guard and ok_v < 0.5:
                    print(f"{step}: step REJECTED (non-finite SOM error)")
                logger.log(step, som_error=err_v, eta=eta, sigma=sigma)
                history.append(dict(step=step, som_error=err_v, ok=ok_v > 0.5))
                print(f"{step}: som_error {err_v:.5f} eta {eta:.3f} sigma {sigma:.2f}")
            if (cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0) \
                    or step == cfg.max_steps:
                with clock.aside(), torch.no_grad():
                    path = _save_ae(_carrier(cfg, ae), step, ae)
                    recon = ae(batch)[0]
                    save_image(recon[:16].float().cpu().numpy(),
                               os.path.join(cfg.output_dir, f"{cfg.name}_som_{step:07d}.png"))
                print("checkpoint:", path)
        rate = clock.rate(cfg.max_steps)
    finally:
        batches.close()
        logger.close()
    return StageResult(ae, path, history, rate)


# ---------------------------------------------------------------------------
# stage 3: finetune_ae
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FinetuneAeConfig:
    """Flags mirror som-diffusion/finetune_ae.py:129-164."""

    manual_seed: int = 0
    platform: str = ""
    batch_size: int = 96
    optimizer: str = "AdamW"
    lr: float = 1e-4
    loss_fn: str = "SmoothL1"
    nan_guard: bool = True
    max_steps: int = 10000
    lr_decay_interval: int = 3000

    som_checkpoint: str = ""
    som_adapt_rate: float = 0.02
    som_adapt_radius: float = 0.25
    som_adapt_batch: int = 8
    som_adapt_skip: int = 0
    latent_loss_weight: float = 0.25

    dataset: str = "synthetic"
    image_size: int = 64
    file_list_fn: str = "file_list.json"
    image_dir_path: str = ""
    image_fn_regex: str = r".*\.png$"

    checkpoint_interval: int = 2500
    log_interval: int = 50
    wandb: bool = False
    project: str = "finetune_ae"
    tags: str = ""
    name: str = "finetune_ae"
    output_dir: str = "outputs/finetune_ae"


def finetune_ae(cfg: FinetuneAeConfig) -> StageResult:
    device = platform_device(cfg.platform)
    if not cfg.som_checkpoint:
        raise ValueError("--som_checkpoint is required")
    torch.manual_seed(cfg.manual_seed)
    ae, _ = load_som_ae(cfg.som_checkpoint, pass_through=True, device=device)
    loss_fn = _recon_loss(cfg.loss_fn)
    schedule = step_decay_schedule(cfg.lr, steps_per_epoch=cfg.lr_decay_interval,
                                   epoch_step_size=1)
    lr_of = host_schedule(schedule)
    opt = make_optimizer(cfg.optimizer, ae.parameters(), schedule)
    adapt_interval = cfg.som_adapt_skip + 1
    batches = _batches(cfg, device)
    logger = MetricLogger(cfg.output_dir, cfg.name, use_wandb=cfg.wandb, project=cfg.project,
                          config=config_to_dict(cfg), tags=cfg.tags)

    def restore_latest():
        # interval checkpoints hold the autoencoder only (the reference's
        # contract): the optimizer state stays as it is
        path = latest_checkpoint(cfg.output_dir) or cfg.som_checkpoint
        if not path:
            return None
        loaded, _ = load_som_ae(path, pass_through=True, device=device)
        ae.load_tokenizer_state(loaded.tokenizer_state())
        print(f"[guard] restored {path}")
        return path

    guard = CheckpointGuard(restore_latest)
    history: List[Dict[str, float]] = []
    clock = _Clock(device)
    adapt_args = (cfg.som_adapt_rate, cfg.som_adapt_radius, cfg.som_adapt_batch)
    try:
        for step in range(1, cfg.max_steps + 1):
            adapt = cfg.som_adapt_rate > 0 and step % adapt_interval == 0
            loss, som_loss, recon, ok = _ae_step(
                ae, opt, next(batches), loss_fn, cfg.nan_guard, cfg.latent_loss_weight,
                adapt_args if adapt else None)
            if step == 1:
                clock.first_done()
            if step % cfg.log_interval == 0 or step == 1:
                loss_v, som_v, ok_v = torch.stack([loss, som_loss, ok.float()]).tolist()
                accepted = ok_v > 0.5 or not cfg.nan_guard
                if not accepted:
                    print(f"{step}: step REJECTED (non-finite loss/grads)")
                guard.record(accepted, step)
                logger.log(step, loss=loss_v, som_loss=som_v, lr=lr_of(step))
                history.append(dict(step=step, loss=loss_v, som_loss=som_v, ok=accepted))
                print(f"{step}: loss {loss_v:.4f} som_loss {som_v:.4f}")
            if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                with clock.aside():
                    path = _save_ae(_carrier(cfg, ae), step, ae)
                    save_image(recon[:16].float().cpu().numpy(), os.path.join(
                        cfg.output_dir, f"{cfg.name}_reconst_{step:07d}.png"))
                print("checkpoint:", path)
        rate = clock.rate(cfg.max_steps)
    finally:
        batches.close()
        logger.close()
    path = _save_ae(_carrier(cfg, ae), cfg.max_steps, ae)
    print("final checkpoint:", path)
    return StageResult(ae, path, history, rate)


# ---------------------------------------------------------------------------
# stage 4: create_diffusion_dataset
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CreateDatasetConfig:
    """Flags mirror som-diffusion/create_diffusion_dataset.py:13-29."""

    manual_seed: int = 42
    platform: str = ""
    batch_size: int = 96
    checkpoint: str = ""
    dataset_fn: str = "diffusion_dataset.npz"
    max_examples: int = -1  # -1: 10,000

    dataset: str = "synthetic"
    image_size: int = 64
    file_list_fn: str = "file_list.json"
    image_dir_path: str = ""
    image_fn_regex: str = r".*\.png$"


def create_diffusion_dataset(cfg: CreateDatasetConfig) -> np.ndarray:
    """Encode images to (N, h, w, 2) SOM coordinates; writes
    ``dataset_fn`` (``data`` and the autoencoder's config as a string) and
    ``dataset_fn + ".json"`` (the config). Returns the array."""
    device = platform_device(cfg.platform)
    if not cfg.checkpoint:
        raise ValueError("--checkpoint is required")
    ae, ae_config = load_som_ae(cfg.checkpoint, pass_through=True, device=device)
    batch_fn = image_batch_fn(cfg.dataset, cfg.file_list_fn, cfg.image_dir_path,
                              cfg.image_fn_regex, cfg.batch_size, cfg.image_size,
                              cfg.manual_seed)
    n_target = cfg.max_examples if cfg.max_examples > 0 else 10_000
    chunks, count = [], 0
    while count < n_target:
        chunks.append(ae.encode_2d(torch.from_numpy(batch_fn())).cpu().numpy())
        count += chunks[-1].shape[0]
    data = np.concatenate(chunks)[:n_target]
    print("encoded latents:", data.shape)
    os.makedirs(os.path.dirname(cfg.dataset_fn) or ".", exist_ok=True)
    np.savez(cfg.dataset_fn, data=data, config=np.array([str(ae_config)], dtype=object))
    with open(cfg.dataset_fn + ".json", "w") as f:
        json.dump(ae_config, f)
    print("written:", cfg.dataset_fn)
    return data


# ---------------------------------------------------------------------------
# stage 5: train_diffusion
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainDiffusionConfig:
    """Flags mirror som-diffusion/train_diffusion.py:175-211."""

    manual_seed: int = 42
    platform: str = ""
    batch_size: int = 128
    optimizer: str = "AdamW"
    lr: float = 1e-4
    loss_fn: str = "MSE"
    nan_guard: bool = True
    accumulation_steps: int = 1
    checkpoint_interval: int = 25000
    eval_interval: int = 2000
    eval_timesteps: int = 1000
    eval_batch_size: int = 8
    eval_trace_steps: int = 20

    weight_decay: float = 0.0
    dropout: float = 0.0
    model_channels: int = 128
    num_res_blocks: int = 3
    channel_mult: Tuple[int, ...] = (1, 2, 3)

    input_dataset: str = "diffusion_dataset.npz"
    firstn: int = -1
    decoder_model: str = ""  # the SOM autoencoder checkpoint (required)
    warmup: int = 500
    max_steps: int = 200_000
    single_batch: bool = False
    ema_decay: float = 0.9999
    log_interval: int = 10

    wandb: bool = False
    project: str = "som-diffusion-diffusion"
    tags: str = ""
    name: str = "diffusion"
    output_dir: str = "outputs/som_diffusion"


def make_unet(cfg: TrainDiffusionConfig, device=None) -> UNetDiffusionModel:
    """The denoiser of the stage (2-channel latents), in train mode."""
    return UNetDiffusionModel(
        in_channels=2, out_channels=2, model_channels=cfg.model_channels,
        num_res_blocks=cfg.num_res_blocks, channel_mult=tuple(cfg.channel_mult),
        dropout=cfg.dropout, device=device).train()


def ddpm_step(state, batch: torch.Tensor, t: torch.Tensor, eps: torch.Tensor, cfg,
              loss_fn) -> torch.Tensor:
    """One eps-prediction step on the device (JAX's ``step_fn``,
    train_diffusion): the loss of the model's eps on x_t against ``eps``,
    backward, the optimizer (optax.MultiSteps with accumulation), the EMA,
    and the old state kept where the loss or the grad norm is not finite.
    Returns the packed (loss, grad norm, ok) f32 (3,) tensor."""
    model, opt = state.model, state.optimizer
    xt, eps = ddpm_corrupt(batch, t, eps)
    opt.zero_grad()
    loss = loss_fn(model(xt, t), eps)
    loss.backward()
    with torch.no_grad():
        loss = loss.detach()
        g = opt.flat_grad()
        gn = torch.linalg.vector_norm(g)
        ok = torch.isfinite(loss) & torch.isfinite(gn)
        proposal, old, new = opt.propose(g), {}, {}
        if state.ema_flat is not None:
            d = cfg.ema_decay
            old["ema"] = state.ema_flat
            new["ema"] = state.ema_flat * d + proposal["params"] * (1.0 - d)
        new = _guarded_update(opt, proposal, ok, cfg.nan_guard, old, new)
        if "ema" in new:
            state.ema_flat.copy_(new["ema"])
        return torch.stack([loss.float(), gn, ok.float()])


def _diffusion_state_dict(state) -> Dict:
    return {"params": state.model.state_dict(),
            "ema": state.ema if state.ema is not None else {},
            "opt_state": state.optimizer.state_dict()}


def sample_latents(model: UNetDiffusionModel, weights: Optional[Dict[str, torch.Tensor]],
                   cfg: TrainDiffusionConfig, latent_shape, seed: int) -> torch.Tensor:
    """The evaluation's x0-reprojection trace (eval_trace_steps, B, h, w, 2)
    with ``weights`` (e.g. the EMA's) in place of the model's own when
    given, in eval mode; the draws from a generator seeded with ``seed``."""
    was_training = model.training
    model.eval()
    try:
        if weights is None:
            eps_fn = model
        else:
            def eps_fn(x, t):
                return torch.func.functional_call(model, weights, (x, t))
        return ddpm_sample(eps_fn, (cfg.eval_batch_size, *latent_shape),
                           timesteps=cfg.eval_timesteps, trace_steps=cfg.eval_trace_steps,
                           generator=torch.Generator(device=model.device).manual_seed(seed))
    finally:
        model.train(was_training)


def train_diffusion(cfg: TrainDiffusionConfig) -> StageResult:
    from world_modelz_tpu_torch.cli.video_diffusion import init_state

    device = platform_device(cfg.platform)
    if not cfg.decoder_model:
        raise ValueError("--decoder_model (som AE checkpoint) is required")
    data = np.load(cfg.input_dataset, allow_pickle=True)["data"]
    if cfg.firstn > 0:
        data = data[: cfg.firstn]
    print("dataset:", data.shape)
    ae, _ = load_som_ae(cfg.decoder_model, pass_through=True, device=device)
    torch.manual_seed(cfg.manual_seed)
    model = make_unet(cfg, device)
    latent_shape = tuple(data.shape[1:])
    print(f"parameters: {sum(p.numel() for p in model.parameters()):,}")
    loss_fn = _recon_loss(cfg.loss_fn)
    # AdamW with warmup and cosine decay, optax.MultiSteps for accumulation,
    # the EMA on flat buffers (the diffusion trainers' state)
    state = init_state(cfg, model)
    lr_of = host_schedule(state.optimizer.schedule)
    gen = torch.Generator(device=device).manual_seed(cfg.manual_seed)
    rng = np.random.default_rng(cfg.manual_seed)
    logger = MetricLogger(cfg.output_dir, cfg.name, use_wandb=cfg.wandb, project=cfg.project,
                          config=config_to_dict(cfg), tags=cfg.tags)
    fixed = torch.from_numpy(data[rng.integers(0, len(data), cfg.batch_size)]).to(device)

    def restore_latest():
        path = latest_checkpoint(cfg.output_dir)
        if not path:
            return None
        restored, at_step, _ = restore_checkpoint(path)
        model.load_state_dict(restored["params"], strict=True)
        if state.ema is not None:
            for k, v in state.ema.items():
                v.copy_(restored["ema"][k])
        state.optimizer.load_state_dict(restored["opt_state"])
        print(f"[guard] restored {path} (step {at_step})")
        return path

    def run_eval(weights, tag, step):
        trace = sample_latents(model, weights, cfg, latent_shape, step)
        # every trace row decoded (train_diffusion.py:163-170)
        imgs = ae.decode_2d(trace.reshape(-1, *latent_shape)).float().cpu().numpy()
        path = os.path.join(cfg.output_dir, f"{cfg.name}_sampling_{step:07d}_{tag}.png")
        save_image(make_grid(imgs, nrow=cfg.eval_batch_size), path)
        print("eval artifact:", path)

    guard = CheckpointGuard(restore_latest)
    history: List[Dict[str, float]] = []
    clock = _Clock(device)
    path = ""
    try:
        for step in range(1, cfg.max_steps + 1):
            if cfg.single_batch:
                batch = fixed
            else:
                batch = torch.from_numpy(
                    data[rng.integers(0, len(data), cfg.batch_size)]).to(device)
            t = torch.rand((batch.shape[0], 1), generator=gen, device=device)
            eps = torch.randn(batch.shape, generator=gen, device=device)
            stats = ddpm_step(state, batch, t, eps, cfg, loss_fn)
            state.step = step
            if step == 1:
                clock.first_done()
            if step % cfg.log_interval == 0 or step == 1:
                loss_v, gn_v, ok_v = stats.tolist()
                accepted = ok_v > 0.5 or not cfg.nan_guard
                if not accepted:
                    print(f"{step}: step REJECTED (non-finite loss/grads)")
                guard.record(accepted, step)
                logger.log(step, loss=loss_v, grad_norm=gn_v, lr=lr_of(step))
                history.append(dict(step=step, loss=loss_v, grad_norm=gn_v, ok=accepted))
                print(f"{step}: loss {loss_v:.3e} gn {gn_v:.2e}")
            if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0:
                with clock.aside():
                    path = save_checkpoint(cfg.output_dir, step, _diffusion_state_dict(state),
                                           config_to_dict(cfg))
                print("checkpoint:", path)
            if cfg.eval_interval and step % cfg.eval_interval == 0:
                with clock.aside():
                    run_eval(None, "base", step)
                    if state.ema is not None:
                        run_eval(state.ema, "ema", step)
        rate = clock.rate(cfg.max_steps)
    finally:
        logger.close()
    return StageResult(model, path, history, rate)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def main_train_ae(argv=None):
    return train_ae(dataclass_cli(TrainAeConfig, argv))


def main_train_som(argv=None):
    return train_som(dataclass_cli(TrainSomConfig, argv))


def main_finetune_ae(argv=None):
    return finetune_ae(dataclass_cli(FinetuneAeConfig, argv))


def main_create_dataset(argv=None):
    return create_diffusion_dataset(dataclass_cli(CreateDatasetConfig, argv))


def main_train_diffusion(argv=None):
    return train_diffusion(dataclass_cli(TrainDiffusionConfig, argv))


STAGES = {
    "train_ae": main_train_ae,
    "train_som": main_train_som,
    "finetune_ae": main_finetune_ae,
    "create_diffusion_dataset": main_create_dataset,
    "train_diffusion": main_train_diffusion,
}


def main(argv=None):
    """``python -m world_modelz_tpu_torch.cli.som_pipeline <stage> [flags]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in STAGES:
        raise SystemExit(f"usage: som_pipeline {{{','.join(STAGES)}}} [--flags]")
    return STAGES[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
