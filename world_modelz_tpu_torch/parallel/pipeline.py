"""Pipeline parallelism: the GPipe microbatch schedule over the mesh's
``pipe`` axis (port of ``world_modelz_tpu.parallel.pipeline``).

A layer stack is split into ``n_stages`` contiguous groups, each held by
one pipe rank (``assign_stages``), and microbatches stream through the
stages by ``ppermute``, tick for tick as JAX's ``lax.scan``:

    tick t: every stage applies its block to the activation it holds,
            stage 0 feeding microbatch t (clamped once the feed drains),
            the last stage emitting its result, then every stage passes
            its result to its right neighbour. After
            ``n_micro + n_stages - 1`` ticks all microbatches have drained.

The feed and the emit are selections on a device flag (JAX's
``jnp.where``), so every rank's autograd graph has the same shape and holds
every tick's ``ppermute``: autograd runs the reverse pipeline, as JAX's
transpose does, each rank reaching the backward collectives in the same
order. The emitted results are summed over ``pipe`` (JAX's final
``psum``, forward only: every rank then computes the same loss from the
same output). The GPipe bubble, an idle fraction
(n_stages - 1) / (n_micro + n_stages - 1), applies.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List

import torch
from torch import nn

from world_modelz_tpu_torch.parallel.distributed import ppermute, reduce_from
from world_modelz_tpu_torch.parallel.mesh import Mesh


def stack_stage_params(stage_params: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack per-stage parameter dicts along a new leading stage axis (all
    stages share names and shapes)."""
    return {k: torch.stack([p[k] for p in stage_params]) for k in stage_params[0]}


def pipeline_apply(
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x_micro: torch.Tensor,
    mesh: Mesh,
) -> torch.Tensor:
    """Run ``x_micro`` through the pipelined block stack.

    Args:
      block_fn: shape-preserving stage ``(params, (mb, ...)) -> (mb, ...)``.
      stage_params: this pipe rank's stage parameters (what ``block_fn``
        takes).
      x_micro: ``(n_micro, mb, ...)`` microbatched input (read by stage 0).
      mesh: the mesh whose ``pipe`` axis carries the stages.

    Returns:
      ``(n_micro, mb, ...)`` outputs, the same on every pipe rank.
    """
    axis = mesh.axis("pipe")
    n_stages, stage = axis.size, axis.index
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    dev = x_micro.device
    # device flags (a fill, so a captured step holds them)
    first = torch.full((), stage == 0, dtype=torch.bool, device=dev)
    last = torch.full((), stage == n_stages - 1, dtype=torch.bool, device=dev)
    zeros = x_micro.new_zeros(x_micro.shape[1:])
    held = zeros
    emitted = []
    for t in range(ticks):
        inp = torch.where(first, x_micro[min(t, n_micro - 1)], held)
        out = block_fn(stage_params, inp)
        # emit before the rotate: microbatch m finishes at the last stage
        # on tick m + n_stages - 1
        if t >= n_stages - 1:
            emitted.append(torch.where(last, out, zeros))
        held = ppermute(out, axis, perm)
    return reduce_from(torch.stack(emitted), axis)


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B // n_micro, ...)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    return x.reshape(n_micro, b // n_micro, *x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """(n_micro, mb, ...) -> (B, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def stage_range(depth: int, n_stages: int, stage: int) -> range:
    """The layers of ``stage`` when ``depth`` splits into ``n_stages``
    contiguous groups."""
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    per = depth // n_stages
    return range(stage * per, (stage + 1) * per)


def assign_stages(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Keep this pipe rank's layers of ``model.transformer.layers`` (the
    others become empty modules, so the state_dict keeps the layers' own
    indices) and return the stage of every layer parameter; the rest of
    the model (embeddings, logit head) stays on every pipe rank."""
    layers = model.transformer.layers
    depth = len(layers)
    mine = stage_range(depth, mesh.n_pipe, mesh.pipe)
    per = depth // mesh.n_pipe
    owner = {}
    for name, _ in model.named_parameters():
        m = re.match(r"transformer\.layers\.(\d+)\.", name)
        if m:
            owner[name] = int(m.group(1)) // per
    for i in range(depth):
        if i not in mine:
            layers[i] = nn.Module()
    return owner
