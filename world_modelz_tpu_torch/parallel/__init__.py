"""Parallelism: the mixture-of-experts FFN and its expert sharding
(``parallel.moe``), the mesh over processes and the tensor-parallel rules
(``parallel.mesh``: ``make_mesh``, ``shard_params``, the batch check), the
collectives (``parallel.distributed``: the process group, the per-rank
data, the data axis's reductions and the model axes' differentiable
collectives), the optimizer state sharded over the data axis
(``parallel.fsdp``, ``--fsdp``), the halo-exchange sequence axis
(``parallel.sequence``) and the GPipe pipeline (``parallel.pipeline``,
``parallel.pipelined_sparse``)."""

from world_modelz_tpu_torch.parallel.distributed import (
    initialize_distributed,
    rank_seed,
    shard_host_batch,
)
from world_modelz_tpu_torch.parallel.mesh import (
    DEFAULT_TP_RULES,
    Mesh,
    ParallelPlan,
    check_batch,
    make_mesh,
    rule_spec,
    shard_params,
)
from world_modelz_tpu_torch.parallel.moe import (
    MoEParams,
    moe_capacity,
    moe_ffn,
    moe_ffn_indexed,
    moe_init,
    moe_reference,
    expert_shardings,
    local_experts,
)

__all__ = [
    "MoEParams",
    "moe_init",
    "moe_capacity",
    "moe_ffn",
    "moe_ffn_indexed",
    "moe_reference",
    "expert_shardings",
    "local_experts",
    "DEFAULT_TP_RULES",
    "ParallelPlan",
    "rule_spec",
    "shard_params",
    "Mesh",
    "make_mesh",
    "check_batch",
    "initialize_distributed",
    "rank_seed",
    "shard_host_batch",
]
