"""Host utilities."""

from world_modelz_tpu_torch.utils.config import (
    config_to_dict,
    dataclass_cli,
    str2bool,
)

__all__ = ["dataclass_cli", "config_to_dict", "str2bool"]
