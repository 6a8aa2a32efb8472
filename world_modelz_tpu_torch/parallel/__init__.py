"""Parallelism. One piece is ported: the mixture-of-experts FFN
(``parallel.moe``) on one device; data, tensor, sequence, pipeline and
expert parallelism wait for ROADMAP A.9."""

from world_modelz_tpu_torch.parallel.moe import (
    MoEParams,
    moe_capacity,
    moe_ffn,
    moe_ffn_indexed,
    moe_init,
    moe_reference,
)

__all__ = [
    "MoEParams",
    "moe_init",
    "moe_capacity",
    "moe_ffn",
    "moe_ffn_indexed",
    "moe_reference",
]
