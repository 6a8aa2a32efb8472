"""Convert a reference (PyTorch) VqAutoEncoder checkpoint to the port's.

Port of ``world_modelz_tpu.cli.import_torch_vqae``:

    python -m world_modelz_tpu_torch.cli.import_torch_vqae \\
        --torch_checkpoint mcvq_checkpoint_0075000.pth \\
        --output_dir outputs/imported_tok

Reads the reference ``train_vqae.py`` checkpoint dict ({'step',
'model_state_dict', 'opt', ...}, minecraft/train_vqae.py:216-223) with
``torch.load(..., weights_only=False)``, since the file embeds the
reference's argparse ``opt`` (load only files you trust). The port's
modules are named after the reference's state_dict keys, so the weights
load as they are; the changes are:

- ``vq.embedding`` (K, D) of a single-latent checkpoint becomes (1, K, D),
  and ``vq.cluster_size`` (K,) becomes (1, K);
- ``vq.activation_count`` and ``vq.accumulated_error``, where present,
  move beside the state_dict (the checkpoint's ``vq_stats``); absent, they
  are zeros.

The architecture comes from the weights' shapes and ``opt``, as the JAX
importer derives it; an encode and decode of a zero image must be finite
and of the token grid's shape. The result is a checkpoint of the tokenizer
trainer's layout (``{"tokenizer", "vq_stats"}`` and the config), which
``cli.train_vqae.load_tokenizer`` and so every diffusion trainer's
``--decoder_model`` read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from world_modelz_tpu_torch.utils.config import config_to_dict, dataclass_cli


@dataclasses.dataclass
class ImportTorchVqaeConfig:
    torch_checkpoint: str = ""  # reference .pth (required)
    output_dir: str = "outputs/imported_tok"
    image_size: int = 64  # recorded in the config for downstream probes


def read_reference(path: str) -> Tuple[Dict[str, torch.Tensor], Any, int, Dict[str, Any]]:
    """A reference checkpoint -> (its model state_dict, its EMA state_dict
    or None, its step, its ``opt`` as a dict)."""
    if not path:
        raise ValueError("--torch_checkpoint (reference .pth) is required")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    opt = ckpt.get("opt")
    opt_d = vars(opt) if opt is not None and not isinstance(opt, dict) else (opt or {})
    return sd, ckpt.get("ema_model_state_dict") or None, int(ckpt.get("step", 0)), opt_d


def run(cfg: ImportTorchVqaeConfig) -> str:
    """Convert ``cfg.torch_checkpoint``; returns the checkpoint's path."""
    from world_modelz_tpu_torch.cli.train_vqae import TrainVqaeConfig, make_tokenizer
    from world_modelz_tpu_torch.train.checkpoint import save_checkpoint

    ref, _, step, opt_d = read_reference(cfg.torch_checkpoint)
    sd = {k: v.float() if v.is_floating_point() else v for k, v in ref.items()}
    if sd["vq.embedding"].ndim == 2:
        sd["vq.embedding"] = sd["vq.embedding"][None]
    if sd["vq.cluster_size"].ndim == 1:
        sd["vq.cluster_size"] = sd["vq.cluster_size"][None]
    stats = {}
    for name in ("activation_count", "accumulated_error"):
        v = sd.pop(f"vq.{name}", None)
        stats[name] = (torch.zeros_like(sd["vq.cluster_size"]) if v is None
                       else (v[None] if v.ndim == 1 else v).float())
    codebook = sd["vq.embedding"]
    tok_cfg = TrainVqaeConfig(
        embedding_dim=int(opt_d.get("embedding_dim", codebook.shape[-1])),
        num_embeddings=int(opt_d.get("num_embeddings", codebook.shape[-2])),
        downscale_steps=int(opt_d.get("downscale_steps", sum(
            1 for k in sd if k.startswith("decoder.decoder_stack.")
            and k.endswith(".bn1.weight")))),
        hidden_planes=int(opt_d.get("hidden_planes", 128)),
        in_channels=int(sd["encoder._conv_1.weight"].shape[1]),
        image_size=cfg.image_size,
        name=str(opt_d.get("name", "imported")),
        output_dir=cfg.output_dir,
    )
    # the check: a strict load, then a finite encode/decode of the grid's shape
    tok = make_tokenizer(tok_cfg, "cpu")
    tok.load_state_dict(sd, strict=True)
    tok.vq.load_stats(stats)
    tok.eval()
    with torch.no_grad():
        z = tok.encode(torch.zeros(1, cfg.image_size, cfg.image_size, tok_cfg.in_channels))
        x = tok.decode(z)
    grid = tok.token_grid_shape((cfg.image_size, cfg.image_size))
    if tuple(z.shape) != (1, *grid) or not bool(torch.isfinite(x).all()):
        raise ValueError(f"the imported tokenizer encodes to {tuple(z.shape)} (want "
                         f"{(1, *grid)}); decode finite: {bool(torch.isfinite(x).all())}")
    path = save_checkpoint(cfg.output_dir, step, {"tokenizer": sd, "vq_stats": stats},
                           config_to_dict(tok_cfg))
    print(f"imported {cfg.torch_checkpoint} (step {step}, {tok_cfg.num_embeddings} codes, "
          f"dim {tok_cfg.embedding_dim}, f{2 ** tok_cfg.downscale_steps}) -> {path}")
    return path


def main(argv=None):
    run(dataclass_cli(ImportTorchVqaeConfig, argv))


if __name__ == "__main__":
    main()
