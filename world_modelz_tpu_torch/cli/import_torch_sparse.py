"""Convert a reference (PyTorch) sparse-diffusion checkpoint to the port's.

Port of ``world_modelz_tpu.cli.import_torch_sparse``:

    python -m world_modelz_tpu_torch.cli.import_torch_sparse \\
        --torch_checkpoint sparse_checkpoint_0400000.pth \\
        --decoder_model outputs/imported_tok/step_0000005 \\
        --output_dir outputs/imported_sparse

Reads the reference ``sparse_diffusion.py`` checkpoint dict (the base and
EMA state_dicts and the argparse ``opt``, minecraft/sparse_diffusion.py:
479-489) with ``torch.load(..., weights_only=False)`` (the file embeds
``opt``; load only files you trust). The port's ``VqSparseDiffusionModel``
is named after the reference's state_dict keys, so both state_dicts load as
they are. The architecture comes from the weights' shapes (the position
tables, the QKV projection, the FFN or, for a mixture of experts, the
expert stack ``layers.{i}.1.fn.w_in`` (E, dim, hidden) as
``convert.sparse_state_dict_from_params`` writes it) and ``heads`` from
``opt``, as the JAX importer derives them; the strict loads and a finite
forward of the logits' shape are the check.

The result is a checkpoint of the sparse trainer's layout: the weights,
the EMA (empty without one), no optimizer state (the reference's Adam state
is not converted) and a fresh loss-aware sampler, with the trainer's
config. The trainer's ``--init_from`` reads it.
"""

from __future__ import annotations

import dataclasses

import torch

from world_modelz_tpu_torch.cli.import_torch_vqae import read_reference
from world_modelz_tpu_torch.utils.config import config_to_dict, dataclass_cli


@dataclasses.dataclass
class ImportTorchSparseConfig:
    torch_checkpoint: str = ""  # reference .pth (required)
    decoder_model: str = ""  # tokenizer checkpoint to record in the config
    output_dir: str = "outputs/imported_sparse"
    image_size: int = 64


def run(cfg: ImportTorchSparseConfig) -> str:
    """Convert ``cfg.torch_checkpoint``; returns the checkpoint's path."""
    from world_modelz_tpu_torch.cli.sparse_diffusion import SparseDiffusionConfig, make_model
    from world_modelz_tpu_torch.train.checkpoint import save_checkpoint
    from world_modelz_tpu_torch.train.importance import loss_aware_init

    ref, ref_ema, step, opt_d = read_reference(cfg.torch_checkpoint)

    def f32(sd):
        return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}

    sd = f32(ref)
    ema = f32(ref_ema) if ref_ema else {}
    s = sd["pos_emb_s.weight"].shape[0]
    h = sd["pos_emb_h.weight"].shape[0]
    w = sd["pos_emb_w.weight"].shape[0]
    dim = sd["embedding.weight"].shape[1]
    num_classes = sd["logit_proj.weight"].shape[0]
    depth = sum(1 for k in sd if k.startswith("transformer.layers.")
                and k.endswith(".0.norm.weight"))
    heads = int(opt_d.get("heads", 1))
    inner = sd["transformer.layers.0.0.fn.to_qkv.weight"].shape[0] // 3
    if inner != dim:
        # the reference trainer always takes dim_head = dim // heads
        # (sparse_diffusion.py:362), and so does the trainer's config
        raise ValueError(f"QKV inner dim {inner} != model dim {dim}: this checkpoint "
                         "was not produced by the reference sparse trainer")
    experts = sd.get("transformer.layers.0.1.fn.w_in")
    if experts is not None:
        moe_experts, mlp_dim = experts.shape[0], experts.shape[2]
    else:
        moe_experts, mlp_dim = 0, sd["transformer.layers.0.1.fn.net.0.weight"].shape[0]
    train_cfg = SparseDiffusionConfig(
        decoder_model=cfg.decoder_model,
        image_size=cfg.image_size,
        S=s, H=h, W=w,
        dim=dim,
        mlp_dim=mlp_dim,
        heads=heads,
        depth=depth,
        num_context=int(opt_d.get("num_context", 512)),
        moe_experts=moe_experts,
        ema_decay=float(opt_d.get("ema_decay", 0.999)) if ema else 0.0,
        name=str(opt_d.get("name", "imported")),
        output_dir=cfg.output_dir,
    )
    # the check: strict loads, then a finite forward of the logits' shape
    model = make_model(train_cfg, num_classes, "cpu").eval()
    if ema:
        model.load_state_dict(ema, strict=True)
    model.load_state_dict(sd, strict=True)
    n = min(16, s * h * w)
    with torch.no_grad():
        logits = model(torch.zeros((1, n), dtype=torch.long), torch.arange(n)[None])
    if tuple(logits.shape) != (1, n, num_classes) or not bool(torch.isfinite(logits).all()):
        raise ValueError(f"the imported denoiser gives logits {tuple(logits.shape)} (want "
                         f"{(1, n, num_classes)}); finite: {bool(torch.isfinite(logits).all())}")
    path = save_checkpoint(
        cfg.output_dir, step,
        {"params": sd, "ema": ema, "opt_state": {},
         "sampler": loss_aware_init().state_dict()},
        config_to_dict(train_cfg))
    print(f"imported {cfg.torch_checkpoint} (step {step}, dim {dim}, depth {depth}, "
          f"volume {s}x{h}x{w}, {num_classes} classes"
          f"{f', {moe_experts} experts' if moe_experts else ''}{', +ema' if ema else ''}) "
          f"-> {path}")
    return path


def main(argv=None):
    run(dataclass_cli(ImportTorchSparseConfig, argv))


if __name__ == "__main__":
    main()
