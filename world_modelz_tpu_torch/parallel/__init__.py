"""Parallelism: the mixture-of-experts FFN (``parallel.moe``), the data
axis across processes (``parallel.distributed``: the process group, the
per-rank data and the collectives; ``parallel.mesh``: ``make_mesh``, the
batch check) and the optimizer state sharded over it (``parallel.fsdp``,
``--fsdp``). Still raising with ROADMAP A.9: ``--n_model``, ``--n_seq``,
``--n_pipe`` and ``n_micro`` (tensor, sequence and pipeline parallelism),
and expert sharding."""

from world_modelz_tpu_torch.parallel.distributed import (
    initialize_distributed,
    rank_seed,
    shard_host_batch,
)
from world_modelz_tpu_torch.parallel.mesh import Mesh, check_batch, make_mesh
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
    "Mesh",
    "make_mesh",
    "check_batch",
    "initialize_distributed",
    "rank_seed",
    "shard_host_batch",
]
