"""Export a trained denoiser checkpoint as a serving artifact.

Port of ``world_modelz_tpu.cli.export_rollout``:

    python -m world_modelz_tpu_torch.cli.export_rollout \\
        --checkpoint outputs/video_diffusion/step_0075000 --use_ema true \\
        --out artifacts/m3_serve

restores a checkpoint of the denoiser trainer (``cli.video_diffusion``)
and its tokenizer as the rollout CLI does (f32, eval mode), and writes the
artifact of ``aot.export_service``: the weights and what
``AOTPrograms.load`` needs to capture the encode and rollout programs at
every ladder size (powers of two up to ``--batch_size``) as CUDA graphs.
``cli.serve_http --exported <dir>`` then serves it without the checkpoint.

The JAX CLI's ``--platforms`` (the lowering targets baked into its
StableHLO) has no meaning here: a CUDA graph is captured where it is
served, so the artifact holds no programs and the flag is left out.
``--platform`` is where the checkpoint is restored: ``""`` the GPU
(raises without one), ``cpu`` the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from world_modelz_tpu_torch._device import DeviceLike, platform_device
from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer
from world_modelz_tpu_torch.cli.video_diffusion import (
    VideoDiffusionConfig,
    make_model,
)
from world_modelz_tpu_torch.models import VQAutoEncoder, VqVideoDiffusionModel
from world_modelz_tpu_torch.train import restore_checkpoint
from world_modelz_tpu_torch.utils.config import config_from_dict, dataclass_cli


@dataclasses.dataclass
class ExportRolloutConfig:
    checkpoint: str = ""  # video-diffusion checkpoint (required)
    out: str = ""  # artifact directory (required)
    platform: str = ""  # "" = the GPU (raises without one), "cpu"
    use_ema: bool = False
    num_frames: int = 8  # generated frames per request
    num_iterations: int = 30  # unmask iterations (main2.py:81)
    topk: int = -1
    batch_size: int = 8  # ladder of power-of-two sizes up to this


def restore_denoiser(
    checkpoint: str, use_ema: bool, device: DeviceLike
) -> Tuple[VQAutoEncoder, VqVideoDiffusionModel, VideoDiffusionConfig, int]:
    """A denoiser checkpoint's f32 weights (the EMA's with ``use_ema``) in
    an eval-mode model with the attention ``backend="auto"``, and the
    training run's tokenizer, as ``cli/rollout.py:Rollout`` restores them;
    the token grid is the training image size's, as the JAX CLIs take it.
    Returns (tokenizer, denoiser, training config, step)."""
    state, step, config = restore_checkpoint(checkpoint)
    train_cfg = config_from_dict(VideoDiffusionConfig, config)
    weights = state["ema"] if use_ema and state.get("ema") else state["params"]
    tok, _ = load_tokenizer(train_cfg.decoder_model, device)
    th, tw = tok.token_grid_shape((train_cfg.image_size, train_cfg.image_size))
    model = make_model(
        train_cfg, (train_cfg.n_past + 1, th, tw), tok.num_embeddings, device)
    model.load_state_dict(weights, strict=True)
    return tok, model.eval(), train_cfg, step


def run(cfg: ExportRolloutConfig) -> Dict[str, Any]:
    from world_modelz_tpu_torch.aot import export_service

    device = platform_device(cfg.platform)
    if not cfg.checkpoint or not cfg.out:
        raise ValueError("--checkpoint and --out are required")
    tok, model, train_cfg, step = restore_denoiser(
        cfg.checkpoint, cfg.use_ema, device)
    meta = export_service(
        cfg.out, tok, model,
        num_frames=cfg.num_frames,
        num_iterations=cfg.num_iterations,
        sample_topk=cfg.topk,
        batch_size=cfg.batch_size,
        seed_frames=train_cfg.n_past + 1,
        image_size=train_cfg.image_size,
        channels=tok.in_channels,
    )
    print(f"exported step-{step} checkpoint -> {cfg.out} (sizes {meta['sizes']})")
    return meta


def main(argv=None):
    run(dataclass_cli(ExportRolloutConfig, argv))


if __name__ == "__main__":
    main()
