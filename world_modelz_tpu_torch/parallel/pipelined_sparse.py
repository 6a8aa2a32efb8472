"""Pipeline-parallel forward for the sparse space-time denoiser (port of
``world_modelz_tpu.parallel.pipelined_sparse``).

The ``VqSparseDiffusionModel``'s homogeneous ``DenseTransformer`` stack is
split into ``n_pipe`` contiguous layer groups, each pipe rank holding its
own (``parallel.mesh.shard_params`` -> ``parallel.pipeline.
assign_stages``), while the embedding gathers and the logit head run on
every pipe rank. Each stage applies the model's own layer modules
(``dense_layer_apply``: the pre-norm ``DenseAttention`` and
``FeedForward``, so the attention takes its flash kernels where the
module's backend does), with the same parameters, so a checkpoint trained
with the plain model runs pipelined and the other way round.

Only stage 0 consumes the feed, so the embeddings' gradient would be this
stage's alone; the feed enters the pipeline through ``copy_to`` over
``pipe``, which sums it over the stages and keeps the replicated
embeddings' gradients the same on every pipe rank. The logit head reads
the summed (replicated) output, so its gradient is already the same on
every pipe rank.

The layers act row by row and the model keeps no batch statistics, so
the port microbatches each rank's own rows; rows a microbatch lacks (a
per-rank batch that ``n_micro`` does not divide) are zero rows, whose
outputs are dropped. Deterministic path only: dropout must be 0.
"""

from __future__ import annotations

import torch
from torch import nn

from world_modelz_tpu_torch.parallel.distributed import copy_to
from world_modelz_tpu_torch.parallel.mesh import Mesh
from world_modelz_tpu_torch.parallel.pipeline import (
    microbatch,
    pipeline_apply,
    stage_range,
    unmicrobatch,
)


def dense_layer_apply(layer: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """One pre-norm block of ``DenseTransformer.layers``:
    x + Attn(LN(x)); x + FF(LN(x))."""
    attn, ff = layer
    x = attn(x) + x
    return ff(x) + x


def _has_dropout(model: nn.Module) -> bool:
    from world_modelz_tpu_torch.models.attention import DenseAttention

    return any((isinstance(m, nn.Dropout) and m.p > 0)
               or (isinstance(m, DenseAttention) and m.dropout > 0)
               for m in model.modules())


def sparse_forward_pipelined(
    model: nn.Module,
    tokens: torch.Tensor,
    indices: torch.Tensor,
    mesh: Mesh,
    *,
    n_micro: int,
) -> torch.Tensor:
    """Pipelined equivalent of ``VqSparseDiffusionModel.forward`` on this
    rank's rows: (B, N) tokens and flat positions -> (B, N, num_classes)
    logits. ``model`` holds this pipe rank's layers."""
    if model.training and _has_dropout(model):
        raise NotImplementedError("pipelined path is deterministic; set dropout=0")
    layers = model.transformer.layers
    mine = [layers[i] for i in stage_range(len(layers), mesh.n_pipe, mesh.pipe)]
    x = model.embedding(tokens.long()) + model.pos_embedding_3d(indices.long())
    x = copy_to(x, mesh.axis("pipe"))
    b = x.shape[0]
    rows = -(-b // n_micro) * n_micro
    if rows > b:
        x = torch.cat([x, x.new_zeros((rows - b, *x.shape[1:]))])

    def stage_fn(stage_layers, xb):
        for layer in stage_layers:
            xb = dense_layer_apply(layer, xb)
        return xb

    y = unmicrobatch(pipeline_apply(stage_fn, mine, microbatch(x, n_micro), mesh))
    return model.logit_proj(y[:b])
