"""Host utilities: dataclass CLI configs, image grids and PNGs, the JSONL
metric logger."""

from world_modelz_tpu_torch.utils.config import (
    config_from_dict,
    config_to_dict,
    dataclass_cli,
    str2bool,
)
from world_modelz_tpu_torch.utils.image import make_grid, save_image
from world_modelz_tpu_torch.utils.logging import MetricLogger

__all__ = [
    "dataclass_cli",
    "config_to_dict",
    "config_from_dict",
    "str2bool",
    "make_grid",
    "save_image",
    "MetricLogger",
]
