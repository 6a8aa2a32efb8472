"""Multi-process initialisation and the data axis's collectives (port of
``world_modelz_tpu.parallel.distributed``).

Every process runs the same trainer. ``initialize_distributed`` joins them
in one ``torch.distributed`` process group: NCCL when the trainer runs on
the GPU, gloo when it was asked for the CPU (the choice follows the device
asked for, never a failure). Host data loading follows the JAX package's
buffer-per-process design: each process draws its own rows of the global
batch from a source seeded by (seed, rank) (``rank_seed``), and
``shard_host_batch`` cuts a rank's rows out of a global batch.

The collectives below take a ``parallel.mesh.Mesh``; with no process group
(one process) each is the identity, so a single-process run issues none.
They run on the device's current stream, so a trainer's step captures them
in its CUDA graph (every rank captures the same collectives in the same
order). ``mean_across`` averages equal-size per-rank means: that is the
global mean the JAX package's global-view step takes, and over one rank
it is the value itself, bit for bit.

The model axes' differentiable collectives take a ``parallel.mesh.Axis``
(the identity on an axis of one): ``copy_to`` (identity forward, sum
backward) and ``reduce_from`` (sum forward, identity backward), Megatron's
pair around column- and row-parallel layers; ``gather_from`` (all-gather
forward, reduce-scatter backward) for features that must be whole on every
rank of a region whose ranks each compute a part of the result; and
``ppermute`` (JAX's ``lax.ppermute``: each source sends to its destination,
a rank no one sends to receives zeros), whose backward is the inverse
permutation. ``ppermute`` runs as one ``all_to_all_single`` over the axis
with empty splits for the ranks that do not exchange, which a CUDA graph
captures on the card.
Every one of them runs on the current stream, so a captured step holds
them; a rank's autograd graph reaches each backward collective in the
same order as every other rank's, since their graphs have one topology.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from world_modelz_tpu_torch.parallel.mesh import Mesh

# torch 2.13 renamed these two (the old names warn); the card's torch has
# only the old ones
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: torch.device,
) -> bool:
    """Join this process to the job's process group; a no-op (False) for
    one process. With no arguments the launcher's environment says
    (``torchrun``'s ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/
    ``MASTER_PORT``); ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id`` override it. The backend is NCCL
    for a CUDA ``device`` (each process takes the GPU of its
    ``LOCAL_RANK``), gloo for the CPU. Returns whether a group was
    joined."""
    device = torch.device(device)
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    print(f"distributed: process {rank}/{world} ({backend})")
    return True


def process_device(device: torch.device) -> torch.device:
    """``device`` with its index: for CUDA, this process's GPU (the one
    ``initialize_distributed`` made current). torch's current device is
    per thread, so in any thread but the main one (the prefetch thread's
    copies) a bare ``"cuda"`` is GPU 0; an indexed device is this
    process's GPU in every thread."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's host data source: ``seed`` itself on rank 0, so
    one process draws what a single-process run draws."""
    return seed + 100_003 * rank


def shard_host_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (an array, a tensor, or a dict of
    them), cut along the leading axis."""
    if isinstance(batch, dict):
        return {k: shard_host_batch(v, mesh) for k, v in batch.items()}
    lo, hi = mesh.rows(batch.shape[0])
    return batch[lo:hi]


def local_rows(draws: Any, mesh: Mesh) -> Any:
    """A dataclass of a global batch's draws (every tensor's leading axis
    the batch) -> the same with this rank's rows (views)."""
    if mesh.world == 1:
        return draws
    return dataclasses.replace(draws, **{
        f.name: shard_host_batch(getattr(draws, f.name), mesh)
        for f in dataclasses.fields(draws)})


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor)."""
    if mesh.group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def all_reduce_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``t`` over the ranks (a new tensor)."""
    if mesh.group is None:
        return t
    return all_reduce_sum(t, mesh) / mesh.world


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0 in rank order."""
    if mesh.group is None:
        return t
    t = t.contiguous()
    out = t.new_empty((mesh.world * t.shape[0], *t.shape[1:]))
    _all_gather(out, t, group=mesh.group)
    return out


def reduce_scatter_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's 1 / world of the mean of ``t`` (whose length divides by
    the world) over the ranks."""
    if mesh.group is None:
        return t
    out = t.new_empty((t.shape[0] // mesh.world, *t.shape[1:]))
    _reduce_scatter(out, t.contiguous(), group=mesh.group)
    return out / mesh.world


def all_gather_into(out: torch.Tensor, shard: torch.Tensor, mesh: Mesh) -> None:
    """``out`` <- every rank's ``shard`` in rank order, in place."""
    if mesh.group is None:
        out.copy_(shard)
        return
    _all_gather(out, shard.contiguous(), group=mesh.group)


class _MeanAcross(torch.autograd.Function):
    """The mean over the ranks, whose gradient is the mean over the ranks
    of the upstream gradients: each rank's loss depends on every rank's
    input through the mean."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_mean(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_mean(g, ctx.mesh), None


def mean_across(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the ranks of equal-size per-rank means ``t``, the
    global mean; differentiable (its backward is a collective too, so only
    eager steps take it: the tokenizer's BatchNorm)."""
    if mesh.group is None:
        return t
    return _MeanAcross.apply(t, mesh)


def global_value(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` (a per-rank mean, on the graph) valued at its mean over the
    ranks, with its own gradient: the gradient a rank takes through it is
    what the global mean passes to that rank's share, when every rank's
    loss reads the same global value (as the MoE load-balance term does).
    No collective runs in the backward, so a captured step may take it."""
    if mesh.group is None:
        return t
    return t + (all_reduce_mean(t.detach(), mesh) - t.detach())


def _axis_all_reduce(t: torch.Tensor, axis) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _axis_all_reduce(g.contiguous(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _axis_all_reduce(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` entering a region whose ranks each use it for a part of the
    result: the identity, with its gradient summed over ``axis``."""
    return x if axis is None or axis.group is None else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum over ``axis`` of each rank's part, with the gradient passed
    to each part as it is (the result is the same on every rank)."""
    return x if axis is None or axis.group is None else _ReduceFrom.apply(x, axis)


def _gather_dim(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
    _all_gather(out, x, group=axis.group)
    return out.movedim(0, dim)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather_dim(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0).contiguous()
        out = g.new_empty((g.shape[0] // ctx.axis.size, *g.shape[1:]))
        _reduce_scatter(out, g, group=ctx.axis.group)
        return out.movedim(0, ctx.dim), None, None


def gather_from(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order; the
    backward sums the ranks' gradients and gives each its part
    (reduce-scatter): each rank's use of the whole is one part of the
    result."""
    if axis is None or axis.group is None:
        return x
    return _GatherFrom.apply(x, axis, dim % x.dim())


def _ppermute(t: torch.Tensor, axis, perm) -> torch.Tensor:
    me = axis.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    t = t.contiguous()
    flat = t.reshape(1, -1)
    inp = flat if dst else flat[:0]
    out = flat.new_empty((len(src), flat.shape[1]))
    dist.all_to_all_single(
        out, inp, output_split_sizes=[int(j in src) for j in range(axis.size)],
        input_split_sizes=[int(j in dst) for j in range(axis.size)], group=axis.group)
    return out.reshape(t.shape) if src else torch.zeros_like(t)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g, ctx.axis, inverse), None, None


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    """JAX's ``lax.ppermute`` over ``axis``: ``perm`` lists (source,
    destination) pairs of axis indices, each index a source at most once and
    a destination at most once; a rank no pair sends to gets zeros. The
    backward sends the gradients back along the inverse pairs."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if axis is None or axis.group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, axis, perm)
