"""Model definitions: tokenizer convs, local-3D and dense attention
transformers, the denoisers."""

from world_modelz_tpu_torch.models.conv import (
    Residual,
    ResidualStack,
    SimpleResidualDecoder,
    SimpleResidualEncoder,
    UpscaleResidual,
)
from world_modelz_tpu_torch.models.tokenizer import (
    VQAutoEncoder,
    tokenizer_inference_cast,
)
from world_modelz_tpu_torch.models.video import (
    VqSparseDiffusionModel,
    VqVideoDiffusionModel,
)

__all__ = [
    "Residual",
    "ResidualStack",
    "SimpleResidualEncoder",
    "UpscaleResidual",
    "SimpleResidualDecoder",
    "VQAutoEncoder",
    "tokenizer_inference_cast",
    "VqVideoDiffusionModel",
    "VqSparseDiffusionModel",
]
