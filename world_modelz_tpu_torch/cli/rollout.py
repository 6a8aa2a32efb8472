"""Long-horizon autoregressive rollout from a trained diffusion checkpoint.

Port of ``world_modelz_tpu.cli.rollout``, the standalone serving path:
restore a checkpoint of the denoiser trainer (``cli.video_diffusion``),
seed a context clip from its data source (pixel clips, also for a run
trained with ``--device_composite``), generate ``num_frames`` future
frames by iterative unmasking (``num_eval_iterations`` denoiser calls per
frame, main2.py:81), decode them, and write one PNG grid per frame (the
clips side by side) and a GIF. Equivalent to ``main2.py --eval`` plus
make_gif.sh, as one command.

The denoiser runs the checkpoint's f32 weights (the EMA's with
``--use_ema``) in eval mode, and the tokenizer is the f32 one of the
training run's ``decoder_model``, uncast, as the JAX rollout loads them.
On the GPU the attention runs the f32 ``local3d_fwd`` kernel and the
encode the ``vq_encode`` kernel.

- ``--fvd true`` scores the generated futures against real clips of the
  same length from the data source (seeded ``manual_seed + 1``) with the
  Fréchet Video Distance harness (``utils/fvd.py``, ``fvd_feature_net``
  ``tiny``, ``i3d`` with ``--fvd_weights`` an I3D .npz in the JAX package's
  layout (or ``WMZ_I3D_WEIGHTS``), or ``tokenizer`` with ``--fvd_weights`` a
  tokenizer checkpoint), generating extra batches up to ``fvd_clips``, and writes
  ``{name}_fvd.json``: the FVD and its bootstrap 95% interval.
- ``--gt_metrics true`` rolls out from clips (seeded ``manual_seed + 2``)
  whose true continuations are held out and writes ``{name}_gt_metrics.json``:
  PSNR and SSIM per horizon step, and the tokenizer round trip's PSNR (the
  ceiling of any token-space model).

The sampler's draws come from a ``torch.Generator`` seeded ``manual_seed``,
not from JAX's keys, so one seed gives other clips than the JAX CLI's (the
data clips are the same).

``--shard_batch`` rolls the batch out data-parallel: launched by
``torchrun`` (NCCL on GPUs, gloo with ``--platform cpu``), each process
rolls out its ``batch_size / world`` clips of the global batch, whose seed
clips and sampler draws are made whole on every rank, so the pixels equal
the unsharded rollout's; rank 0 gathers them and alone writes the PNGs,
the GIF, FVD and PSNR/SSIM. A batch the processes do not divide raises.

Run (the GPU by default, ``--platform cpu`` for the CPU):

    python -m world_modelz_tpu_torch.cli.rollout --checkpoint \\
        outputs/video_diffusion/step_0200000 --preset fast --fvd true
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from world_modelz_tpu_torch._device import platform_device
from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer
from world_modelz_tpu_torch.cli.video_diffusion import (
    VideoDiffusionConfig,
    build_clip_fn,
    make_model,
)
from world_modelz_tpu_torch.data import as_frames, batch_to
from world_modelz_tpu_torch.diffusion import generator_noise, rollout_frames
from world_modelz_tpu_torch.parallel.distributed import (
    all_gather_rows,
    initialize_distributed,
    process_device,
    shard_host_batch,
)
from world_modelz_tpu_torch.parallel.mesh import Mesh, make_mesh
from world_modelz_tpu_torch.train import restore_checkpoint
from world_modelz_tpu_torch.utils import fvd as fvd_lib
from world_modelz_tpu_torch.utils.config import config_from_dict, dataclass_cli
from world_modelz_tpu_torch.utils.image import make_grid, save_gif, save_image
from world_modelz_tpu_torch.utils.metrics import psnr, ssim


@dataclasses.dataclass
class RolloutConfig:
    checkpoint: str = ""  # video-diffusion checkpoint (required)
    platform: str = ""  # "" = the GPU (raises without one), "cpu"
    use_ema: bool = False
    shard_batch: bool = False  # data-parallel rollout over the processes
    batch_size: int = 4
    num_frames: int = 16
    num_eval_iterations: int = 30
    topk: int = -1
    # swept operating points of the JAX package (benchmarks/sampler_sweep.py):
    # "fast" = 10 iterations + topk 25, "reference" = the reference's own
    # 30 / -1 (main2.py:81). Empty = the num_eval_iterations/topk flags.
    preset: str = ""
    manual_seed: int = 0
    output_dir: str = "outputs/rollout"
    name: str = "rollout"
    fps: float = 5.0
    # FVD scoring (utils/fvd.py)
    fvd: bool = False
    fvd_clips: int = 64  # clips per side; extra rollout batches as needed
    fvd_feature_net: str = "tiny"  # tiny | i3d | tokenizer
    fvd_weights: str = ""  # the I3D .npz, or the tokenizer extractor's checkpoint
    fvd_batch_size: int = 8  # feature-extraction batch
    # next-frame prediction quality: roll out from contexts whose true
    # continuations are held out, report PSNR/SSIM per horizon step (plus
    # the tokenizer-roundtrip ceiling) to <name>_gt_metrics.json
    gt_metrics: bool = False


SAMPLER_PRESETS = {
    # swept operating points — see RolloutConfig.preset
    "fast": dict(num_eval_iterations=10, topk=25),
    "reference": dict(num_eval_iterations=30, topk=-1),
}


class Rollout:
    """One restored checkpoint's rollout: the f32 denoiser (built at the
    first batch, from the token grid it probes), the tokenizer, the data
    source and the sampler's generator, on ``device``."""

    def __init__(self, cfg: RolloutConfig, device: torch.device, mesh: Optional[Mesh] = None):
        state, self.step, config = restore_checkpoint(cfg.checkpoint)
        self.cfg = cfg
        # the rollout takes pixel clips: a trajectory-shipping training
        # config (--device_composite) must not hand it dict batches
        self.train_cfg = dataclasses.replace(
            config_from_dict(VideoDiffusionConfig, config), device_composite=False)
        self.device = device
        self.weights = (state["ema"] if cfg.use_ema and state.get("ema")
                        else state["params"])
        self.tok, _ = load_tokenizer(self.train_cfg.decoder_model, device)
        self.clip_fn, self.sampler = build_clip_fn(self.train_cfg, cfg.manual_seed)
        self.generator = torch.Generator(device=device).manual_seed(cfg.manual_seed)
        self.model = None
        self.token_shape = None  # (S, h, w), once the first batch is encoded
        # the data axis a --shard_batch rollout spreads its batch over
        self.mesh = mesh or Mesh()

    @torch.no_grad()
    def generate(self, frames: Optional[np.ndarray] = None) -> np.ndarray:
        """One rollout batch -> (B, num_frames, H, W, C) decoded pixels.

        ``frames`` overrides the seed clip (B, n_past+1, H, W, C); by
        default a fresh batch is drawn from the data source. On a data axis
        every rank rolls out its rows of the batch, under the whole batch's
        draws, and every rank returns the whole batch's pixels."""
        if frames is None:
            frames = self.clip_fn(self.cfg.batch_size)
        n = len(frames)
        frames = shard_host_batch(frames, self.mesh)
        x = as_frames(batch_to(frames, self.device), self.train_cfg.image_size)
        b, s, hh, ww, c = x.shape
        tokens = self.tok.encode(x.reshape(b * s, hh, ww, c))
        tokens = tokens.reshape(b, s, *tokens.shape[1:])
        k = self.tok.num_embeddings
        if self.model is None:
            self.token_shape = (s, int(tokens.shape[2]), int(tokens.shape[3]))
            self.model = make_model(self.train_cfg, self.token_shape, k, self.device)
            self.model.load_state_dict(self.weights, strict=True)
            self.model.eval()
        draws = {"generator": self.generator}
        if self.mesh.world > 1:  # the whole batch's draws, this rank's rows
            lo, hi = self.mesh.rows(n)
            noise = generator_noise(self.generator, (n, *tokens.shape[2:]), k)
            draws = {"noise": lambda t, i: tuple(d[lo:hi] for d in noise(t, i))}
        gen = rollout_frames(
            self.model, tokens, num_frames=self.cfg.num_frames, num_classes=k,
            mask_token=k, num_iterations=self.cfg.num_eval_iterations,
            sample_topk=self.cfg.topk, **draws,
        )  # (b, T, h, w)
        t = gen.shape[1]
        decoded = self.tok.decode(gen.reshape(b * t, *gen.shape[2:])).float()
        decoded = all_gather_rows(decoded.reshape(b, t, *decoded.shape[1:]), self.mesh)
        return decoded.cpu().numpy()

    def clips(self, n_past: int, seed: int, n: int) -> np.ndarray:
        """``n`` float clips of ``n_past + 1`` frames from the data source
        seeded ``seed``."""
        fn, sampler = build_clip_fn(
            dataclasses.replace(self.train_cfg, n_past=n_past), seed)
        try:
            return as_frames(fn(n), self.train_cfg.image_size).numpy()
        finally:
            if sampler is not None:
                sampler.close()

    def close(self) -> None:
        """Stop the data source's sampler, if it has one."""
        if self.sampler is not None:
            self.sampler.close()


@dataclasses.dataclass
class RolloutResult:
    decoded: np.ndarray  # the first batch, (B, T, H, W, C)
    step: int  # the checkpoint's step
    fvd: Optional[dict]  # the {name}_fvd.json record
    gt_metrics: Optional[dict]  # the {name}_gt_metrics.json record
    gen_videos: Optional[np.ndarray]  # the clips FVD scored, each side
    real_videos: Optional[np.ndarray]
    batch_seconds: List[float]  # the wall of each rollout batch
    rollout: Rollout


def run(cfg: RolloutConfig) -> RolloutResult:
    if cfg.preset:
        if cfg.preset not in SAMPLER_PRESETS:
            raise ValueError(
                f"unknown preset {cfg.preset!r}; "
                f"choose from {sorted(SAMPLER_PRESETS)}"
            )
        cfg = dataclasses.replace(cfg, **SAMPLER_PRESETS[cfg.preset])
        print(f"sampler preset {cfg.preset}: "
              f"{cfg.num_eval_iterations} iterations, topk {cfg.topk}")
    device = platform_device(cfg.platform)
    if not cfg.checkpoint:
        raise ValueError("--checkpoint (video-diffusion run) is required")
    mesh = None
    if cfg.shard_batch:
        initialize_distributed(device=device)
        device = process_device(device)
        mesh = make_mesh()
        if cfg.batch_size % mesh.world != 0:
            raise ValueError(f"batch_size {cfg.batch_size} must be divisible by "
                             f"{mesh.world} devices")

    ro = Rollout(cfg, device, mesh)
    try:
        return _run(cfg, device, ro)
    finally:
        ro.close()


def _run(cfg: RolloutConfig, device: torch.device, ro: Rollout) -> RolloutResult:
    """The rest of ``run``, on its restored checkpoint (``run`` closes it).
    Every rank rolls out; rank 0 alone writes and scores."""
    walls: List[float] = []
    lead = ro.mesh.rank == 0

    def generate(frames=None):
        t0 = time.perf_counter()
        out = ro.generate(frames)
        walls.append(time.perf_counter() - t0)
        return out

    decoded = generate()
    b, t = decoded.shape[:2]

    if lead:
        os.makedirs(cfg.output_dir, exist_ok=True)
        gif_frames = []
        for i in range(t):
            grid = make_grid(decoded[:, i], nrow=b)
            save_image(grid, os.path.join(cfg.output_dir, f"{cfg.name}_frame_{i:04d}.png"))
            gif_frames.append(grid)
        gif_path = os.path.join(cfg.output_dir, f"{cfg.name}.gif")
        save_gif(gif_frames, gif_path, fps=cfg.fps)
        print(f"rollout: {t} frames -> {gif_path}")

    fvd_record = gen_videos = real_videos = None
    if cfg.fvd:
        gen_clips = [decoded]
        n_gen = b
        while n_gen < cfg.fvd_clips:
            gen_clips.append(generate())
            n_gen += b
        gen_videos = np.concatenate(gen_clips, axis=0)[: cfg.fvd_clips]
    if cfg.fvd and lead:
        # real clips of the same length, from the training data source
        real_videos = ro.clips(t - 1, cfg.manual_seed + 1, len(gen_videos))
        extractor = fvd_lib.make_extractor(
            cfg.fvd_feature_net, cfg.fvd_weights or None, device)
        real_f = fvd_lib.extract_features(extractor, real_videos, cfg.fvd_batch_size)
        gen_f = fvd_lib.extract_features(extractor, gen_videos, cfg.fvd_batch_size)
        score, lo, hi = fvd_lib.fvd_bootstrap(real_f, gen_f, seed=cfg.manual_seed)
        fvd_record = {
            "step": ro.step,
            "fvd": score,
            "fvd_ci95": [lo, hi],
            "feature_net": cfg.fvd_feature_net,
            "clips": int(len(gen_videos)),
            "frames_per_clip": int(t),
        }
        print("FVD:", json.dumps(fvd_record))
        with open(os.path.join(cfg.output_dir, f"{cfg.name}_fvd.json"), "w") as f:
            json.dump(fvd_record, f)

    gt_record = None
    if cfg.gt_metrics:
        # clips long enough to hold the seed AND the true continuation:
        # generated frame m re-predicts clip index n_past + m
        # (rollout_frames masks the last seed slot, then shifts)
        n_past = ro.train_cfg.n_past
        long_clip = ro.clips(n_past + cfg.num_frames - 1, cfg.manual_seed + 2,
                             cfg.batch_size)
        seed_clip = long_clip[:, : n_past + 1]
        gt = long_clip[:, n_past : n_past + cfg.num_frames]
        pred = generate(seed_clip)  # (B, T, H, W, C)
    if cfg.gt_metrics and lead:
        # tokenizer-roundtrip ceiling: the best any token-space model can do
        bt = torch.from_numpy(gt.reshape(-1, *gt.shape[2:])).to(device)
        ceiling = ro.tok.decode(ro.tok.encode(bt)).float().cpu().numpy()
        ceiling = ceiling.reshape(gt.shape)

        pred_t, gt_t, ceil_t = map(torch.from_numpy, (pred, gt, ceiling))
        per_step = []
        for m in range(pred.shape[1]):
            per_step.append({
                "horizon": m + 1,
                "psnr": float(psnr(pred_t[:, m], gt_t[:, m])),
                "ssim": float(ssim(pred_t[:, m], gt_t[:, m])),
                "tokenizer_ceiling_psnr": float(psnr(ceil_t[:, m], gt_t[:, m])),
            })
        gt_record = {
            "step": ro.step,
            "clips": int(pred.shape[0]),
            "per_horizon": per_step,
            "mean_psnr": float(np.mean([d["psnr"] for d in per_step])),
            "mean_ssim": float(np.mean([d["ssim"] for d in per_step])),
        }
        print("gt_metrics:", json.dumps(gt_record))
        with open(os.path.join(cfg.output_dir, f"{cfg.name}_gt_metrics.json"), "w") as f:
            json.dump(gt_record, f, indent=1)

    return RolloutResult(decoded, ro.step, fvd_record, gt_record, gen_videos,
                         real_videos, walls, ro)


def main(argv=None):
    run(dataclass_cli(RolloutConfig, argv))


if __name__ == "__main__":
    main()
