"""Host utilities: dataclass CLI configs, image grids, PNGs and GIFs, the
JSONL metric logger, evaluation metrics (PSNR, SSIM, codebook usage), the
FVD harness (``utils.fvd``), FLOP counts and the card's peaks
(``utils.flops``), the tracing and timing helpers (``utils.profiling``)
and the span recorder (``utils.tracing``)."""

from world_modelz_tpu_torch.utils.config import (
    config_from_dict,
    config_to_dict,
    dataclass_cli,
    str2bool,
)
from world_modelz_tpu_torch.utils.image import (
    make_grid,
    read_gif,
    read_png,
    save_gif,
    save_image,
)
from world_modelz_tpu_torch.utils.logging import MetricLogger
from world_modelz_tpu_torch.utils.metrics import codebook_usage, psnr, ssim

__all__ = [
    "dataclass_cli",
    "config_to_dict",
    "config_from_dict",
    "str2bool",
    "make_grid",
    "save_image",
    "save_gif",
    "read_png",
    "read_gif",
    "MetricLogger",
    "psnr",
    "ssim",
    "codebook_usage",
]
