"""Convert a reference (PyTorch) video-diffusion checkpoint to the port's.

Port of ``world_modelz_tpu.cli.import_torch_video``:

    python -m world_modelz_tpu_torch.cli.import_torch_video \\
        --torch_checkpoint model3_checkpoint_0075000.pth \\
        --decoder_model outputs/imported_tok/step_0000005 \\
        --output_dir outputs/imported_m3

Reads the reference ``main.py``/``main2.py`` checkpoint dict ({'step',
'model_state_dict', 'ema_model_state_dict', 'opt', ...},
minecraft/main2.py:302-314) with ``torch.load(..., weights_only=False)``
(the file embeds ``opt``; load only files you trust). The port's
``VqVideoDiffusionModel`` is named after the reference's state_dict keys,
so both state_dicts load as they are: no key is renamed. The architecture
comes from the weights' shapes (the position tables, the projections) and
``heads`` and ``extents`` from ``opt``, as the JAX importer derives them;
a forward of a zero clip must be finite and of the logits' shape.

The result is a checkpoint of the denoiser trainer's layout: the weights,
the EMA (empty without one), no optimizer state (the reference's Adam state
is not converted) and a fresh loss-aware sampler, with the trainer's config
(``decoder_model`` should be the matching tokenizer, converted first with
``import_torch_vqae``). The rollout CLI, ``--init_from`` and ``--eval`` read
it.
"""

from __future__ import annotations

import dataclasses

import torch

from world_modelz_tpu_torch.cli.import_torch_vqae import read_reference
from world_modelz_tpu_torch.utils.config import config_to_dict, dataclass_cli


@dataclasses.dataclass
class ImportTorchVideoConfig:
    torch_checkpoint: str = ""  # reference .pth (required)
    decoder_model: str = ""  # tokenizer checkpoint to record in the config
    output_dir: str = "outputs/imported_video"
    image_size: int = 64  # recorded for downstream probes


def run(cfg: ImportTorchVideoConfig) -> str:
    """Convert ``cfg.torch_checkpoint``; returns the checkpoint's path."""
    from world_modelz_tpu_torch.cli.video_diffusion import VideoDiffusionConfig, make_model
    from world_modelz_tpu_torch.train.checkpoint import save_checkpoint
    from world_modelz_tpu_torch.train.importance import loss_aware_init

    ref, ref_ema, step, opt_d = read_reference(cfg.torch_checkpoint)

    def f32(sd):
        return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}

    sd = f32(ref)
    ema = f32(ref_ema) if ref_ema else {}
    s = sd["transformer.pos_emb_s.weight"].shape[0]
    h = sd["transformer.pos_emb_h.weight"].shape[0]
    w = sd["transformer.pos_emb_w.weight"].shape[0]
    dim = sd["transformer.embedding.weight"].shape[1]
    num_classes = sd["logit_proj.weight"].shape[0]
    depth = sum(1 for k in sd if k.startswith("transformer.layers.")
                and k.endswith(".0.norm.weight"))
    heads = int(opt_d.get("heads", 1))
    inner = sd["transformer.layers.0.0.fn.to_q.weight"].shape[0]
    mlp_dim = sd["transformer.layers.0.1.fn.net.0.weight"].shape[0]
    extents = opt_d.get("extents", opt_d.get("extent", "3,3,3"))
    if isinstance(extents, str):
        extents = tuple(int(v) for v in extents.split(","))
    ema_decay = float(opt_d.get("ema_decay", 0.999 if ema else 0.0))
    train_cfg = VideoDiffusionConfig(
        decoder_model=cfg.decoder_model,
        image_size=cfg.image_size,
        n_past=s - 1,
        dim=dim,
        extents=tuple(extents),
        depth=depth,
        mlp_dim=mlp_dim,
        dim_head=inner // heads,
        heads=heads,
        ema_decay=ema_decay if ema else 0.0,
        name=str(opt_d.get("name", "imported")),
        output_dir=cfg.output_dir,
    )
    # the check: strict loads, then a finite forward of the logits' shape
    model = make_model(train_cfg, (s, h, w), num_classes, "cpu").eval()
    if ema:
        model.load_state_dict(ema, strict=True)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        logits = model(torch.zeros((1, s, h, w), dtype=torch.long))
    if tuple(logits.shape) != (1, h, w, num_classes) or not bool(torch.isfinite(logits).all()):
        raise ValueError(f"the imported denoiser gives logits {tuple(logits.shape)} (want "
                         f"{(1, h, w, num_classes)}); finite: {bool(torch.isfinite(logits).all())}")
    path = save_checkpoint(
        cfg.output_dir, step,
        {"params": sd, "ema": ema, "opt_state": {},
         "sampler": loss_aware_init().state_dict()},
        config_to_dict(train_cfg))
    print(f"imported {cfg.torch_checkpoint} (step {step}, dim {dim}, depth {depth}, "
          f"grid {s}x{h}x{w}, {num_classes} classes{', +ema' if ema else ''}) -> {path}")
    return path


def main(argv=None):
    run(dataclass_cli(ImportTorchVideoConfig, argv))


if __name__ == "__main__":
    main()
