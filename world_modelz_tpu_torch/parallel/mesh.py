"""The data axis (port of ``world_modelz_tpu.parallel.mesh``, its data
axis only).

JAX's trainers build a device mesh over every device and shard the batch
over its ``data`` axis. The port's mesh is the ``torch.distributed`` world:
one process a GPU (or a CPU process under gloo), the whole world on the data
axis. Tensor, sequence and pipeline axes (``n_model``, ``n_seq``,
``n_pipe`` > 1) are not ported (ROADMAP A.9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch.distributed as dist

from world_modelz_tpu_torch.utils.config import unported


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis: its ``rank`` of ``world``,
    and the process group the collectives run in (None for one process
    that joined no group: then no collective runs)."""

    rank: int = 0
    world: int = 1
    group: Optional[Any] = None

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows of a global batch of ``n``."""
        b = n // self.world
        return self.rank * b, (self.rank + 1) * b

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1,
              n_pipe: int = 1) -> Mesh:
    """The data axis over the process group's world (one process without a
    group: a world of one and no collectives). ``n_data`` must be None or
    the world; ``n_model``, ``n_seq`` or ``n_pipe`` > 1 raise
    NotImplementedError (ROADMAP A.9)."""
    for name, n in (("--n_model", n_model), ("--n_seq", n_seq), ("--n_pipe", n_pipe)):
        if n > 1:
            raise unported(f"{name} > 1 (tensor, sequence and pipeline axes)", "A.9")
    if dist.is_available() and dist.is_initialized():
        mesh = Mesh(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)
    else:
        mesh = Mesh()
    if n_data is not None and n_data != mesh.world:
        raise ValueError(f"n_data={n_data}, but the data axis is the whole world "
                         f"({mesh.world} processes)")
    return mesh


def check_batch(batch_size: int, mesh: Mesh) -> int:
    """The per-rank batch; a batch the data axis does not divide raises
    ValueError, as the JAX trainers refuse it."""
    if batch_size % mesh.world != 0:
        raise ValueError(
            f"batch_size {batch_size} must be divisible by the data-parallel "
            f"axis ({mesh.world} devices)")
    return batch_size // mesh.world


def attach(module: Any, mesh: Mesh) -> Any:
    """Give every submodule that reduces over the batch (one with a
    ``mesh`` attribute: BatchNorm, the VQ tokenizer, the MoE FFN) the
    mesh, so its batch statistics are the global batch's."""
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    return module
