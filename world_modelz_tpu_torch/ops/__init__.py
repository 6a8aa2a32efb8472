"""Plain PyTorch ops: the vector quantizer (``ops.vq``, exported here),
the self-organizing map (``ops.som``) and flax's dense apply
(``ops.dense``)."""

from world_modelz_tpu_torch.ops.vq import (
    VQ1State,
    VQOutput,
    VQState,
    codebook_distances,
    vq_apply,
    vq_apply_fused,
    vq_decode,
    vq_decode_masked,
    vq_encode,
    vq_init,
    vq_reset_stats,
    vq_reuse_inactive,
    vq_train_stats_reference,
    vq1_apply,
    vq1_init,
)

__all__ = [
    "VQState",
    "VQOutput",
    "vq_init",
    "codebook_distances",
    "vq_encode",
    "vq_decode",
    "vq_decode_masked",
    "vq_apply",
    "vq_apply_fused",
    "vq_train_stats_reference",
    "vq_reuse_inactive",
    "vq_reset_stats",
    "VQ1State",
    "vq1_init",
    "vq1_apply",
]
