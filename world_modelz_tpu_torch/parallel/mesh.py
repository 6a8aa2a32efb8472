"""The device mesh over processes, and the tensor-parallel rules (port of
``world_modelz_tpu.parallel.mesh``).

JAX's trainers build a device mesh over every device: ``('data', 'model')``,
``('data', 'seq', 'model')`` with sequence parallelism, ``('pipe', 'data',
'model')`` with pipeline parallelism, ``model`` fastest. The port's mesh is
the ``torch.distributed`` world (one process a GPU, or a CPU process under
gloo) laid out the same way: ``make_mesh`` gives this process its
coordinate on each axis and a process group for each axis of size > 1 (the
ranks that differ only in that coordinate; a model group is consecutive
ranks). ``Mesh.rank``, ``.world`` and ``.group`` are the data axis, so code
that knows only the data axis reads the same fields as before.

``DEFAULT_TP_RULES``, ``rule_spec`` and ``shard_params`` are JAX's
path-pattern rules on the port's parameter names (the reference state_dict
keys, ``convert.py``'s): column-parallel weights split their output rows
over ``model``, row-parallel ones their input columns, the MoE FFNs their
expert axis; a dimension the axis does not divide, and every unmatched
parameter, is replicated. ``shard_params`` applies them to a model in
place: each matched parameter becomes this rank's shard and its module
learns its tensor-parallel axis (``models/attention.py`` runs the split
forward). Under ``n_pipe`` > 1 it gives each pipe rank its stage's layers
instead. The returned ``ParallelPlan`` cuts whole state_dicts (and flat
optimizer vectors) into a rank's part and gathers them back, so a
checkpoint is always the whole model and resumes under any layout.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

MODEL = "model"
Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis seen from this process: its ``index`` on the axis,
    the axis ``size`` and the process group of the ranks along it (None for
    a size of one: no collective runs)."""

    index: int = 0
    size: int = 1
    group: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the mesh: ``rank``, ``world`` and ``group``
    are the data axis (the group None for one process that joined no
    group), the other axes' coordinate, size and group follow; ``process``
    is the global rank (rank 0 of the world writes); ``data_seq_group``
    (with ``n_seq`` > 1) joins the ranks of one model coordinate, over which
    the parameter gradient is reduced once."""

    rank: int = 0
    world: int = 1
    group: Optional[Any] = None
    model: int = 0
    n_model: int = 1
    model_group: Optional[Any] = None
    seq: int = 0
    n_seq: int = 1
    seq_group: Optional[Any] = None
    pipe: int = 0
    n_pipe: int = 1
    pipe_group: Optional[Any] = None
    process: int = 0
    data_seq_group: Optional[Any] = None

    @property
    def lead(self) -> bool:
        """The process that writes checkpoints, logs and evaluations."""
        return self.process == 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.world, MODEL: self.n_model, "seq": self.n_seq,
                "pipe": self.n_pipe}

    def axis(self, name: str) -> Axis:
        if name == "data":
            return Axis(self.rank, self.world, self.group)
        if name == "data_seq":
            return Axis(self.rank * self.n_seq + self.seq, self.world * self.n_seq,
                        self.data_seq_group)
        return Axis(getattr(self, name), getattr(self, f"n_{name}"),
                    getattr(self, f"{name}_group"))

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows of a global batch of ``n``."""
        b = n // self.world
        return self.rank * b, (self.rank + 1) * b

    def barrier(self) -> None:
        """Wait for every process of the world."""
        if self.group is not None or self.n_model * self.n_seq * self.n_pipe > 1:
            dist.barrier()


_GROUPS: Dict[Tuple, Mesh] = {}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1,
              n_pipe: int = 1) -> Mesh:
    """The mesh over the process group's world (one process without a
    group: a world of one and no collectives), JAX's layouts: ``('data',
    'model')``, ``('data', 'seq', 'model')`` when ``n_seq`` > 1, ``('pipe',
    'data', 'model')`` when ``n_pipe`` > 1. ``n_data`` None takes what the
    other axes leave. Pipe with seq, and a world the axes do not divide,
    raise ValueError. Every process calls it with the same arguments (the
    groups are made collectively, once a world)."""
    if n_pipe > 1 and n_seq > 1:
        raise ValueError("combine pipe with data/model axes, not seq")
    for name, n in (("n_model", n_model), ("n_seq", n_seq), ("n_pipe", n_pipe)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    joined = dist.is_available() and dist.is_initialized()
    world, process = (dist.get_world_size(), dist.get_rank()) if joined else (1, 0)
    inner = n_model * n_seq * n_pipe
    if n_data is None:
        if world % inner:
            raise ValueError(
                f"the mesh axes (model={n_model}, seq={n_seq}, pipe={n_pipe}) do "
                f"not divide the world of {world} processes")
        n_data = world // inner
    if n_data * inner != world:
        raise ValueError(
            f"n_data={n_data} x model={n_model} x seq={n_seq} x pipe={n_pipe} "
            f"is not the world of {world} processes")
    if inner == 1:
        return Mesh(process, world, dist.group.WORLD if joined else None,
                    process=process)
    key = (id(dist.group.WORLD), n_data, n_model, n_seq, n_pipe)
    if key in _GROUPS:
        return _GROUPS[key]
    if n_pipe > 1:
        names, shape = ("pipe", "data", MODEL), (n_pipe, n_data, n_model)
    elif n_seq > 1:
        names, shape = ("data", "seq", MODEL), (n_data, n_seq, n_model)
    else:
        names, shape = ("data", MODEL), (n_data, n_model)
    grid = np.arange(world).reshape(shape)
    coord = dict(zip(names, (int(c) for c in np.argwhere(grid == process)[0])))
    groups: Dict[str, Any] = {}
    for i, name in enumerate(names):
        if shape[i] == 1:
            continue
        # every slice along the axis is a group; every process makes them all
        for ranks in np.moveaxis(grid, i, -1).reshape(-1, shape[i]).tolist():
            g = dist.new_group(ranks)
            if process in ranks:
                groups[name] = g
    if n_seq > 1:
        groups["data_seq"] = groups["seq"]
        if n_data > 1:
            for ranks in np.moveaxis(grid, 2, 0).reshape(n_model, -1).tolist():
                g = dist.new_group(ranks)
                if process in ranks:
                    groups["data_seq"] = g
    mesh = Mesh(coord["data"], n_data, groups.get("data"),
                coord.get(MODEL, 0), n_model, groups.get(MODEL),
                coord.get("seq", 0), n_seq, groups.get("seq"),
                coord.get("pipe", 0), n_pipe, groups.get("pipe"), process,
                groups.get("data_seq"))
    _GROUPS[key] = mesh
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


# Tensor-parallel rules for the transformer stacks (JAX's DEFAULT_TP_RULES
# on the port's names; nn.Linear's weight is (out, in), flax's kernel
# (in, out)). Searched in the state_dict key; the first match wins.
DEFAULT_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    # dense transformer attention (DenseAttention's fused q | k | v rows)
    (r"to_qkv\.weight$", (MODEL, None)),
    # local-3D attention (Local3dAttention)
    (r"layers\.\d+\.0\.fn\.to_[qkv]\.weight$", (MODEL, None)),
    (r"to_out\.0\.weight$", (None, MODEL)),
    # FFNs: first Dense column-parallel, second row-parallel
    (r"layers\.\d+\.1\.fn\.net\.0\.weight$", (MODEL, None)),
    (r"layers\.\d+\.1\.fn\.net\.3\.weight$", (None, MODEL)),
    # MoE FFNs: the expert axis over 'model'; the router stays replicated
    (r"layers\.\d+\.1\.fn\.w_in$", (MODEL, None, None)),
    (r"layers\.\d+\.1\.fn\.w_out$", (MODEL, None, None)),
    (r"layers\.\d+\.1\.fn\.b_in$", (MODEL, None)),
    (r"layers\.\d+\.1\.fn\.b_out$", (MODEL, None)),
)


def rule_spec(name: str, shape: Sequence[int], mesh: Mesh,
              rules: Sequence[Tuple[str, Spec]]) -> Spec:
    """The placement of one parameter under ``rules`` (regex search on its
    state_dict key, first match wins): a tuple naming the mesh axis each
    dimension splits over (None: whole), or () for replicated; a match
    that some named axis does not divide, and no match, is replicated."""
    sizes = mesh.shape
    for pattern, spec in rules:
        if re.search(pattern, name):
            for dim, axis in enumerate(spec):
                if axis is not None and (dim >= len(shape) or shape[dim] % sizes[axis]):
                    return ()
            return tuple(spec)
    return ()


def split_dim(spec: Spec) -> Optional[int]:
    """The dimension a ``rule_spec`` splits over ``model`` (None: none)."""
    return spec.index(MODEL) if MODEL in spec else None


@dataclasses.dataclass
class ParallelPlan:
    """Where each of a model's parameters lives: ``full`` the whole shapes
    in the model's parameter order; ``splits`` the parameters cut over the
    model axis, name -> (dim, chunks) (the fused q | k | v rows cut each of
    their ``chunks`` blocks, so a rank holds its heads of each); ``owner``
    the parameters held by one pipe rank alone, name -> stage. Everything
    else is replicated. Its gathers are collectives: every process of the
    mesh calls them in the same order."""

    mesh: Mesh
    full: Dict[str, Tuple[int, ...]]
    splits: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    owner: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def trivial(self) -> bool:
        return not self.splits and not self.owner

    def held(self, name: str) -> bool:
        return self.owner.get(name, self.mesh.pipe) == self.mesh.pipe

    def local_names(self) -> List[str]:
        return [n for n in self.full if self.held(n)]

    def split_names(self) -> List[str]:
        """The parameters whose values differ across the ranks of one
        tensor-parallel or pipeline group (a global norm sums them over
        it); the rest are the same on every rank."""
        return [n for n in self.local_names() if n in self.splits or n in self.owner]

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``full``."""
        if name not in self.splits:
            return full
        dim, chunks = self.splits[name]
        n, r = self.mesh.n_model, self.mesh.model
        x = full.movedim(dim, 0)
        x = x.reshape(chunks, n, -1, *x.shape[1:])[:, r]
        return x.reshape(-1, *x.shape[2:]).movedim(0, dim).contiguous()

    def gather(self, name: str, local: Optional[torch.Tensor],
               like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole tensor from every rank's part (``local`` None where
        another pipe rank holds it; ``like`` then gives dtype and device)."""
        mesh = self.mesh
        if name in self.owner:
            src = self.owner[name]
            if local is None:
                local = torch.empty(self.full[name], dtype=like.dtype, device=like.device)
            if mesh.pipe_group is not None:
                local = local.contiguous()
                dist.broadcast(local, dist.get_global_rank(mesh.pipe_group, src),
                               group=mesh.pipe_group)
            return local
        if name not in self.splits or mesh.model_group is None:
            return local
        dim, chunks = self.splits[name]
        n = mesh.n_model
        x = local.movedim(dim, 0).contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=mesh.model_group)
        x = torch.stack(parts).reshape(n, chunks, -1, *x.shape[1:]).transpose(0, 1)
        return x.reshape(-1, *x.shape[3:]).movedim(0, dim).contiguous()

    def shard_named(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A whole state_dict -> this rank's (its held names, its parts)."""
        return {k: self.shard(k, v) for k, v in tensors.items() if self.held(k)}

    def gather_named(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's state_dict (or any name -> tensor dict of its held
        parameters) -> the whole one, on every rank."""
        if self.trivial:
            return dict(tensors)
        like = next(iter(tensors.values()))
        out = {k: v for k, v in tensors.items() if k not in self.full}
        for k in self.full:
            out[k] = self.gather(k, tensors.get(k), like)
        return out

    def _sizes(self, names) -> List[int]:
        return [int(np.prod(self.full[n])) if n not in self.splits
                else int(np.prod(self.full[n])) // self.mesh.n_model for n in names]

    def gather_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """A flat vector over this rank's parameters (the optimizer's
        layout) -> the flat vector over the whole model's."""
        if self.trivial:
            return flat
        names = self.local_names()
        parts = dict(zip(names, torch.split(flat, self._sizes(names))))
        shaped = {n: p.reshape(self._local_shape(n)) for n, p in parts.items()}
        whole = self.gather_named(shaped)
        return torch.cat([whole[n].reshape(-1) for n in self.full])

    def shard_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """The inverse of ``gather_flat``: a whole flat vector -> this
        rank's."""
        if self.trivial:
            return flat
        sizes = [int(np.prod(s)) for s in self.full.values()]
        whole = {n: p.reshape(self.full[n])
                 for n, p in zip(self.full, torch.split(flat, sizes))}
        local = self.shard_named(whole)
        return torch.cat([local[n].reshape(-1) for n in self.local_names()])

    def _local_shape(self, name: str) -> Tuple[int, ...]:
        shape = list(self.full[name])
        if name in self.splits:
            shape[self.splits[name][0]] //= self.mesh.n_model
        return tuple(shape)


def shard_params(model: nn.Module, mesh: Mesh,
                 rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES) -> ParallelPlan:
    """Place ``model``'s parameters on ``mesh``, in place, and return the
    plan. With ``n_pipe`` > 1, ``parallel.pipeline.assign_stages`` keeps
    this pipe rank's layers (the rest of the model replicated). Otherwise
    each module whose parameters ``rules`` split over ``model`` takes this
    rank's shards and its ``tp`` axis (``models/attention.py``: the
    attention modules, ``FeedForward``, ``MoEFeedForward``); a module some of
    whose matched parameters the axis does not divide stays whole
    (replicated), and so does an attention without an output projection.
    The numbers are the same under any placement."""
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    plan = ParallelPlan(mesh, full)
    if mesh.n_pipe > 1:
        from world_modelz_tpu_torch.parallel.pipeline import assign_stages

        plan.owner = assign_stages(model, mesh)
        model.parallel_plan = plan
        return plan
    if mesh.n_model == 1:
        model.parallel_plan = plan
        return plan
    axis = mesh.axis(MODEL)
    for prefix, module in model.named_modules():
        names = getattr(module, "tp_params", None)
        if names is None:
            continue
        keys = {a: f"{prefix}.{a}" if prefix else a for a in names}
        specs = {a: rule_spec(k, full[k], mesh, rules) for a, k in keys.items() if k in full}
        if not specs or any(split_dim(s) is None for s in specs.values()):
            continue
        supported = getattr(module, "tp_supported", None)
        if supported is not None and not supported(mesh.n_model):
            continue
        chunks = getattr(module, "tp_chunks", {})
        with torch.no_grad():
            for a, spec in specs.items():
                plan.splits[keys[a]] = (split_dim(spec), chunks.get(a, 1))
                path, _, attr = a.rpartition(".")
                owner = module.get_submodule(path)
                whole = getattr(owner, attr).detach()
                setattr(owner, attr, nn.Parameter(plan.shard(keys[a], whole)))
        module.tp = axis
    model.parallel_plan = plan
    return plan


def plan_of(model: nn.Module) -> ParallelPlan:
    """The plan ``shard_params`` left on ``model`` (a replicated one when
    it was never sharded)."""
    plan = getattr(model, "parallel_plan", None)
    if plan is None:
        plan = ParallelPlan(Mesh(), {n: tuple(p.shape) for n, p in model.named_parameters()})
    return plan
