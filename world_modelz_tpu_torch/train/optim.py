"""Optimizer construction and the global gradient norm.

Port of ``world_modelz_tpu.train.optim`` (``optax.adamw`` / ``optax.adam``)
and of ``optax.MultiSteps`` (``--accumulation_steps``, JAX's
cli/video_diffusion.py:459-460), written so that a whole train step can be
captured in a CUDA graph:

- the parameters are views into one flat buffer (the f32 masters), and
  so are the two Adam moments (and the gradient accumulator), so an
  update is a few elementwise launches over the flat buffers, and the
  guard's select of the old or the new state is one ``torch.where`` per
  buffer;
- the update count is a device tensor, and the learning rate is the
  schedule evaluated on it in float32 before it is incremented, as optax
  evaluates its schedule (``schedules.py``): with a warmup the first update
  runs at lr = schedule(0) = 0 while the moments move;
- the arithmetic is optax's, in its order: mu = (1 - b1) g + b1 mu, nu =
  (1 - b2) g^2 + b2 nu, u = mu_hat / (sqrt(nu_hat) + eps) with the bias
  corrections at count + 1, then (AdamW) u + wd p, then p + (-lr) u.

``propose`` computes the new state out of place, ``assign`` writes a state
into the live buffers; ``step`` is the two for the parameters' ``.grad``.

Data parallelism (``parallel.mesh``): with a mesh, ``reduced_grad`` is the
flat gradient averaged over the ranks (one all-reduce), so every rank takes
the global batch's update; ``parallel.fsdp.ShardedOptimizer`` keeps only
this rank's shard of the state instead. One process has no group, and then
no collective runs. The model axes: under ``--n_seq`` each rank's gradient
is its frames' part, so it is summed over the seq axis too (one
all-reduce over the data x seq ranks; ``ShardedOptimizer`` sums over seq
before its reduce-scatter over data); under
tensor or pipeline parallelism the flat buffers hold this rank's
parameters (``split``: which of them differ across the ranks of the
model or pipe axis), and the global grad norm sums those over that axis
and counts the replicated ones once.
torch's own ``capturable`` optimizers are not used: they refuse CPU
tensors, so the CPU and the card would run different update code, and
their per-parameter state would make the guard's select a launch per
tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from world_modelz_tpu_torch.parallel.distributed import all_reduce_mean, reduce_from
from world_modelz_tpu_torch.parallel.mesh import Axis, Mesh

LearningRate = Union[float, Callable]


class ScheduledOptimizer:
    """AdamW (``weight_decay`` applied) or Adam over flat buffers, with its
    schedule and, for ``accumulation_steps`` k > 1, optax.MultiSteps: each
    call folds the gradient into the running mean acc + (g - acc) / (n + 1)
    of the n mini-steps so far, every k-th applies the inner update with
    the mean and clears it, the others leave the parameters, the moments and
    the count as they are (zero updates). The schedule counts inner updates
    only.

    ``count`` is the number of inner updates applied (optax's count, the
    schedule's step). A step that is rejected (``assign`` of the old state)
    leaves it, so the schedule, where it was."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        schedule: LearningRate,
        *,
        weight_decay: Optional[float] = 0.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        accumulation_steps: int = 1,
        mesh: Optional[Mesh] = None,
        split: Optional[Tuple[List[bool], Axis]] = None,
    ):
        self.mesh = mesh or Mesh()
        self.params: List[torch.nn.Parameter] = list(params)
        if not self.params:
            raise ValueError("no parameters to optimize")
        if len({p.dtype for p in self.params}) != 1 or not self.params[0].is_floating_point():
            raise ValueError("the optimizer keeps its parameters in one flat buffer "
                             "of one floating dtype")
        if accumulation_steps < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got {accumulation_steps}")
        self.schedule = schedule if callable(schedule) else (lambda _: schedule)
        self.weight_decay = weight_decay  # None: Adam (no decayed weights)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.accumulation_steps = int(accumulation_steps)
        self._sizes = [p.numel() for p in self.params]
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
            for p, view in zip(self.params, self.views(self.flat)):
                p.data = view
        dev = self.flat.device
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count_t = torch.zeros((), dtype=torch.int32, device=dev)
        if self.accumulation_steps > 1:
            self.acc = torch.zeros_like(self.flat)
            self.mini_step = torch.zeros((), dtype=torch.int32, device=dev)
        # the elements whose parameters differ across the split axis
        self.split_axis, self.split_mask = None, None
        if split is not None and split[1].group is not None and any(split[0]):
            self.split_axis = split[1]
            self.split_mask = torch.cat([
                torch.full((n,), bool(f), device=dev) for n, f in zip(self._sizes, split[0])])

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """``flat`` (one value a parameter element) as tensors shaped like
        the parameters, in their order."""
        return [v.view_as(p) for v, p in zip(torch.split(flat, self._sizes), self.params)]

    def moments(self, p: torch.nn.Parameter):
        """(mu, nu) of parameter ``p``: views of the flat moments."""
        i = next(i for i, q in enumerate(self.params) if q is p)
        return self.views(self.mu)[i], self.views(self.nu)[i]

    @property
    def count(self) -> int:
        return int(self.count_t)

    def flat_grad(self) -> torch.Tensor:
        """The parameters' ``.grad`` (zeros where None) as one float32 buffer."""
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
            for p in self.params])

    def reduced_grad(self) -> torch.Tensor:
        """The flat gradient of the global batch's mean loss: this rank's
        ``flat_grad`` summed over the seq axis and averaged over the data
        axis (under ``--n_seq`` one all-reduce over both)."""
        if self.mesh.n_seq > 1:
            return reduce_from(self.flat_grad(), self.mesh.axis("data_seq")) / self.mesh.world
        return all_reduce_mean(self.flat_grad(), self.mesh)

    def seq_summed(self, g: torch.Tensor) -> torch.Tensor:
        """``g`` summed over the seq axis (each rank's is its frames')."""
        return reduce_from(g, self.mesh.axis("seq"))

    def grad_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The global L2 norm of a ``reduced_grad``."""
        if self.split_mask is None:
            return torch.linalg.vector_norm(g)
        return self.split_norm(g)

    def split_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The global norm with split parameters: the replicated elements'
        squares once, the split ones' summed over the split axis."""
        sq = g * g
        parts = torch.stack([torch.where(self.split_mask, 0.0, sq).sum(),
                             torch.where(self.split_mask, sq, 0.0).sum()])
        parts = self.across_shards(parts)
        return torch.sqrt(parts[0] + reduce_from(parts[1], self.split_axis))

    def across_shards(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the shards of the state (one here)."""
        return t

    def publish(self) -> None:
        """Make the parameters the model reads current after an ``assign``
        (they are the flat buffer here: nothing to do)."""

    def local_shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole flat vector (all of it here)."""
        return full

    def gather_full(self, local: torch.Tensor) -> torch.Tensor:
        """The whole flat vector of a ``local_shard`` (itself here)."""
        return local

    def sync_from_params(self) -> None:
        """Take the state's parameters from the model's after a load (they
        are the same buffer here: nothing to do)."""

    def extra_tensors(self) -> List[torch.Tensor]:
        """Buffers besides ``state_tensors`` that a step writes."""
        return []

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """The live buffers an update changes, by name."""
        live = {"params": self.flat, "mu": self.mu, "nu": self.nu, "count": self.count_t}
        if self.accumulation_steps > 1:
            live.update(acc=self.acc, mini_step=self.mini_step)
        return live

    @torch.no_grad()
    def propose(self, g: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The state after one call with the flat gradient ``g``, out of
        place (the live buffers are only read)."""
        b1, b2 = self.b1, self.b2
        k = self.accumulation_steps
        new: Dict[str, torch.Tensor] = {}
        if k > 1:  # optax.MultiSteps with use_grad_mean
            acc = self.acc + (g - self.acc) / (self.mini_step + 1).to(torch.float32)
            emit = self.mini_step == k - 1
            g = acc
        count_inc = self.count_t + 1
        mu = (1.0 - b1) * g + b1 * self.mu
        nu = (1.0 - b2) * (g * g) + b2 * self.nu
        c = count_inc.to(torch.float32)
        mu_hat = mu / (1.0 - torch.pow(b1, c))
        nu_hat = nu / (1.0 - torch.pow(b2, c))
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        del mu_hat, nu_hat  # freed before the next whole-size temporaries
        if self.weight_decay is not None:
            u = u + self.weight_decay * self.flat
        lr = self.schedule(self.count_t)
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), lr, dtype=torch.float32, device=self.flat.device)
        params = self.flat + (-lr) * u
        if k > 1:
            new.update(
                params=torch.where(emit, params, self.flat),
                mu=torch.where(emit, mu, self.mu),
                nu=torch.where(emit, nu, self.nu),
                count=torch.where(emit, count_inc, self.count_t),
                acc=torch.where(emit, torch.zeros_like(acc), acc),
                mini_step=torch.remainder(self.mini_step + 1, k),
            )
        else:
            new.update(params=params, mu=mu, nu=nu, count=count_inc)
        return new

    @torch.no_grad()
    def assign(self, state: Dict[str, torch.Tensor]) -> None:
        """Write ``state`` (``state_tensors``' keys) into the live buffers, in
        place: a captured step keeps reading the same addresses."""
        for key, live in self.state_tensors().items():
            live.copy_(state[key])

    def step(self) -> None:
        """Apply one call with the parameters' ``.grad`` (reduced over the
        data axis)."""
        self.assign(self.propose(self.reduced_grad()))
        self.publish()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The moments, the count (and the accumulator); the parameters are
        the model's."""
        return {k: v for k, v in self.state_tensors().items() if k != "params"}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Restore the moments, the count (and the accumulator) in place."""
        live = {k: v for k, v in self.state_tensors().items() if k != "params"}
        if set(sd) != set(live):
            raise ValueError(
                f"optimizer state has {sorted(sd)}, this optimizer (accumulation_steps="
                f"{self.accumulation_steps}) keeps {sorted(live)}")
        for key, t in live.items():
            if tuple(sd[key].shape) != tuple(t.shape):
                raise ValueError(
                    f"optimizer state {key}: shape {tuple(sd[key].shape)}, expected "
                    f"{tuple(t.shape)}")
            t.copy_(sd[key])


def make_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    learning_rate: LearningRate,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    accumulation_steps: int = 1,
    mesh: Optional[Mesh] = None,
    fsdp: bool = False,
    split: Optional[Tuple[List[bool], Axis]] = None,
) -> ScheduledOptimizer:
    """``"adamw"`` (optax.adamw, eps 1e-8) or ``"adam"`` (optax.adam), with
    optax.MultiSteps when ``accumulation_steps`` > 1, over the data axis of
    ``mesh``: replicated, or with ``fsdp`` sharded over it
    (``parallel.fsdp.ShardedOptimizer``)."""
    name = name.lower()
    if name not in ("adamw", "adam"):
        raise ValueError(f"Unsupported optimizer: {name!r}")
    cls = ScheduledOptimizer
    if fsdp:
        from world_modelz_tpu_torch.parallel.fsdp import ShardedOptimizer as cls
    return cls(
        params, learning_rate, weight_decay=weight_decay if name == "adamw" else None,
        b1=b1, b2=b2, accumulation_steps=accumulation_steps, mesh=mesh, split=split)


@torch.no_grad()
def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all gradients (main2.py:200-205), on the device: a
    float32 scalar tensor."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))
