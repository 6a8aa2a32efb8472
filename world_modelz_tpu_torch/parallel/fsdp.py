"""Sharded optimizer state, ``--fsdp`` (the port of
``world_modelz_tpu.parallel.fsdp``).

JAX's FSDP is a placement: each large parameter leaf, its EMA and its
optimizer moments split over the ``data`` axis, the compiler gathering and
reduce-scattering; the numbers are those of data parallelism. The port
shards the optimizer's side of its flat parameter buffer
(``train/optim.py``), as ZeRO's first two stages do: the flat vector is
padded to a multiple of the world and each rank owns one contiguous
1 / world of the f32 parameters, which it alone updates, of Adam's moments
(and the gradient accumulator) and of the EMA. The model's parameters stay
whole on every rank, as do the gradients until the reduce-scatter and the
activations: a rank holds 4 + 16 / world bytes of f32 state a parameter
(the whole parameters; its part of them, of both moments and of the EMA)
against replicated data parallelism's 16. A step

- reduce-scatters the flat gradient (each rank receives the global mean of
  its own shard; JAX's FSDP all-reduces instead, which the port does not
  copy),
- takes the grad norm from the ranks' shard norms, gathered,
- updates its own shard (the guard's select included), and
- all-gathers the shards into the whole flat buffer that the model's
  parameters are views of, before the next forward.

Checkpoints are whole: ``state_dict`` gathers the moments (every rank
calls it; rank 0 writes), and ``load_state_dict`` takes this rank's slice
of whole tensors, so an FSDP checkpoint resumes a replicated run and the
other way round. Without a process group (one process) it is the
replicated optimizer's arithmetic on a world of one.

With ``--n_model`` (JAX's FSDP leaves the tensor-parallel dimension to the
rules and shards the rest over ``data``, fsdp.py:12-14) each rank's flat
buffer holds its tensor-parallel shards and is sharded over its data
group; the checkpoints gather both (``parallel.mesh.ParallelPlan``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from world_modelz_tpu_torch.parallel.distributed import (
    all_gather_into,
    all_gather_rows,
    all_reduce_sum,
    reduce_scatter_mean,
)
from world_modelz_tpu_torch.train.optim import ScheduledOptimizer


class ShardedOptimizer(ScheduledOptimizer):
    """``ScheduledOptimizer`` whose ``flat`` (the f32 parameters this rank
    updates), ``mu``, ``nu`` (and ``acc``) are this rank's shard; the
    model's parameters are views of ``full``, the whole padded flat buffer,
    which every rank holds."""

    def __init__(self, params, schedule, **kw):
        super().__init__(params, schedule, **kw)
        world, rank = self.mesh.world, self.mesh.rank
        self.numel = self.flat.numel()
        self.shard_size = -(-self.numel // world)
        with torch.no_grad():
            self.full = torch.zeros(self.shard_size * world, dtype=self.flat.dtype,
                                    device=self.flat.device)
            self.full[: self.numel].copy_(self.flat)
            for p, view in zip(self.params, self.views(self.full[: self.numel])):
                p.data = view
            self.flat = self.local_shard(self.full).clone()
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        if self.accumulation_steps > 1:
            self.acc = torch.zeros_like(self.flat)
        if self.split_mask is not None:
            self.split_mask = self.local_shard(self.split_mask)

    def _padded(self, t: torch.Tensor) -> torch.Tensor:
        pad = self.shard_size * self.mesh.world - t.shape[0]
        return torch.cat([t, t.new_zeros(pad)]) if pad else t

    def local_shard(self, full: torch.Tensor) -> torch.Tensor:
        lo = self.mesh.rank * self.shard_size
        return self._padded(full.reshape(-1))[lo: lo + self.shard_size]

    def gather_full(self, local: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(local, self.mesh)[: self.numel]

    def reduced_grad(self) -> torch.Tensor:
        """This rank's shard of the global mean gradient (reduce-scatter),
        summed over the seq axis first."""
        return reduce_scatter_mean(self._padded(self.seq_summed(self.flat_grad())),
                                   self.mesh)

    def grad_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The norm of the ranks' shard norms, gathered (with split
        parameters, the shards' sums of squares summed first)."""
        if self.split_mask is not None:
            return self.split_norm(g)
        return torch.linalg.vector_norm(
            all_gather_rows(torch.linalg.vector_norm(g)[None], self.mesh))

    def across_shards(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.mesh)

    @torch.no_grad()
    def publish(self) -> None:
        all_gather_into(self.full, self.flat, self.mesh)

    @torch.no_grad()
    def sync_from_params(self) -> None:
        self.flat.copy_(self.local_shard(self.full))

    def extra_tensors(self) -> List[torch.Tensor]:
        return [self.full]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole moments (gathered: every rank calls it), the count
        (and the accumulator and its step)."""
        return {k: self.gather_full(v) if v.shape == self.flat.shape else v
                for k, v in super().state_dict().items()}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Restore from whole tensors (an FSDP or a replicated checkpoint):
        each rank takes its shard."""
        sd = {k: self.local_shard(v.to(self.flat.device)) if v.dim() == 1
              and v.shape[0] == self.numel else v for k, v in sd.items()}
        super().load_state_dict(sd)
