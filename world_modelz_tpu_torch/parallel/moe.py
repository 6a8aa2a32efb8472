"""Mixture-of-experts FFN with capacity-based top-1 routing.

Port of ``world_modelz_tpu.parallel.moe`` (the expert-sharding helper
``expert_shardings`` waits for the port's parallelism, ROADMAP A.9). The
routing is JAX's:

- the gate ``x @ w_gate`` in the dtype of ``x``, then an f32 softmax and
  the top-1 expert (the first of equal maxima);
- a token's slot is the number of earlier tokens of its row (along N) sent
  to the same expert; tokens at or past ``capacity`` are dropped (their
  output is 0; the residual carries them);
- the expert FFNs (Dense -> tanh GELU -> Dense) run in f32 on the
  parameters as given, and a kept token's output is its expert's output
  times its gate probability, cast back to the dtype of ``x``;
- the load-balance loss is ``E * sum_e mean(sel_e) * mean(gate_e)``
  (Switch Transformer eq. 4).

Three forms compute it. ``moe_ffn`` is JAX's: one-hot (B, N, E, C)
dispatch and combine tensors and einsums; it is the plain version.
``moe_ffn_indexed`` (the models' main path) moves the same tokens by index:
a scatter of each token's row number into an (B, E * C) slot table, a
gather of the expert batches from it and a gather of each token's output
from its slot. Every index it writes is distinct (a dropped token writes
past the table, an empty slot reads a zero row), so its forward and its
backward scatters are deterministic, and it reads nothing on the host,
so a step using it captures in a CUDA graph. In f32 the expert products
are the same GEMMs on the same operands, and a one-hot product adds only
zeros, so its output equals ``moe_ffn``'s. ``moe_reference`` evaluates
each token with its own expert (no capacity), the golden path of tests.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class MoEParams(NamedTuple):
    """Stacked expert FFNs and the router (JAX's layout).

    w_gate: (D, E) router.
    w_in:   (E, D, H) expert up-projections.   b_in:  (E, H)
    w_out:  (E, H, D) expert down-projections. b_out: (E, D)
    """

    w_gate: torch.Tensor
    w_in: torch.Tensor
    b_in: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor


def moe_init(
    dim: int, hidden: int, num_experts: int, *,
    generator: Optional[torch.Generator] = None, device=None,
    dtype: torch.dtype = torch.float32,
) -> MoEParams:
    """Unit normals scaled by dim^-0.5 (router, up) and hidden^-0.5 (down),
    zero biases, as JAX's ``moe_init`` (from the port's generator)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    return MoEParams(
        w_gate=normal(dim, num_experts) * dim**-0.5,
        w_in=normal(num_experts, dim, hidden) * dim**-0.5,
        b_in=torch.zeros((num_experts, hidden), device=device, dtype=dtype),
        w_out=normal(num_experts, hidden, dim) * hidden**-0.5,
        b_out=torch.zeros((num_experts, dim), device=device, dtype=dtype),
    )


def moe_capacity(capacity_factor: float, n: int, num_experts: int) -> int:
    """Slots per expert per row: max(1, ceil(capacity_factor * N / E))
    (JAX's models/attention.py:117)."""
    return max(1, int(math.ceil(capacity_factor * n / num_experts)))


def route(params: MoEParams, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gate (B, N, E) f32 softmax, expert (B, N) int64 top-1)."""
    gate = torch.softmax((x @ params.w_gate).float(), dim=-1)
    return gate, torch.argmax(gate, dim=-1)


def load_balance_loss(gate: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
    """E * sum_e mean(sel_e) * mean(gate_e) over the (B, N) tokens."""
    e = gate.shape[-1]
    sel = F.one_hot(expert, e).to(gate.dtype)
    return torch.sum(sel.mean((0, 1)) * gate.mean((0, 1))) * e


def _experts(params: MoEParams, expert_in: torch.Tensor) -> torch.Tensor:
    """(E, B, C, D) f32 expert batches -> (E, B, C, D) f32 outputs."""
    h = (torch.einsum("ebcd,edh->ebch", expert_in, params.w_in.float())
         + params.b_in[:, None, None, :].float())
    h = F.gelu(h, approximate="tanh")
    return (torch.einsum("ebch,ehd->ebcd", h, params.w_out.float())
            + params.b_out[:, None, None, :].float())


def _slots(gate: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
    """(B, N) 0-based slot of each token: its running count along N among
    the tokens of its row routed to its expert."""
    sel = F.one_hot(expert, gate.shape[-1])
    return torch.cumsum(sel, dim=1).gather(-1, expert[..., None])[..., 0] - 1


def moe_ffn(
    params: MoEParams, x: torch.Tensor, *, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``moe_ffn``: top-1 routed expert FFN through the one-hot
    dispatch and combine einsums (the plain version).

    x: (B, N, D) tokens; ``capacity`` slots per expert per row (``>= N``
    is lossless). Returns (y (B, N, D) in the dtype of x, the load-balance
    loss, an f32 scalar)."""
    e = params.w_gate.shape[1]
    gate, expert = route(params, x)
    sel = F.one_hot(expert, e).to(gate.dtype)  # (B, N, E)
    gate_top = torch.sum(gate * sel, dim=-1)  # (B, N)
    slot = torch.cumsum(sel, dim=1) * sel  # 1-based where selected
    slot_idx = (torch.sum(slot, dim=-1) - 1.0).long()
    keep = slot_idx < capacity
    # an overflowing token's one-hot row lands past the last slot: all zero
    slot_oh = F.one_hot(torch.where(keep, slot_idx, capacity),
                        capacity + 1)[..., :capacity].to(gate.dtype)
    dispatch = sel[:, :, :, None] * slot_oh[:, :, None, :]  # (B, N, E, C)
    expert_in = torch.einsum("bnec,bnd->ebcd", dispatch, x.float())
    expert_out = _experts(params, expert_in)
    combine = dispatch * gate_top[:, :, None, None]
    y = torch.einsum("bnec,ebcd->bnd", combine, expert_out).to(x.dtype)
    return y, load_balance_loss(gate, expert)


def moe_ffn_indexed(
    params: MoEParams, x: torch.Tensor, *, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` with the tokens moved by index (the main path): the same
    result, without the (B, N, E, C) tensors."""
    b, n, d = x.shape
    e = params.w_gate.shape[1]
    slots = e * capacity
    gate, expert = route(params, x)
    gate_top = gate.gather(-1, expert[..., None])[..., 0]  # (B, N)
    slot = _slots(gate, expert)
    keep = slot < capacity
    flat = expert * capacity + slot
    rows = torch.arange(n, device=x.device).expand(b, n)
    # the slot table: a kept token's row number at its slot; a dropped one
    # writes past the table (distinct places); an empty slot keeps n, the
    # zero row appended to x
    table = torch.full((b, slots + n), n, dtype=torch.long, device=x.device)
    table.scatter_(1, torch.where(keep, flat, slots + rows), rows)
    table = table[:, :slots]
    xin = torch.cat([x.float(), x.new_zeros((b, 1, d), dtype=torch.float32)], dim=1)
    expert_in = xin.gather(1, table[..., None].expand(b, slots, d))
    expert_in = expert_in.view(b, e, capacity, d).transpose(0, 1)
    expert_out = _experts(params, expert_in.contiguous())  # (E, B, C, D)
    out = torch.cat([expert_out.transpose(0, 1).reshape(b, slots, d),
                     expert_out.new_zeros((b, 1, d))], dim=1)
    # a dropped token reads the appended zero row
    picked = out.gather(1, torch.where(keep, flat, slots)[..., None].expand(b, n, d))
    y = (picked * gate_top[..., None]).to(x.dtype)
    return y, load_balance_loss(gate, expert)


def moe_reference(params: MoEParams, x: torch.Tensor) -> torch.Tensor:
    """JAX's ``moe_reference``: every token through its own top-1 expert
    (no capacity, no dispatch tensors), times its gate probability."""
    gate, expert = route(params, x)
    gate_top = gate.gather(-1, expert[..., None])[..., 0]
    d = x.shape[-1]
    xi = x.reshape(-1, 1, d).float()
    ei = expert.reshape(-1)
    h = F.gelu(torch.bmm(xi, params.w_in[ei].float())[:, 0] + params.b_in[ei],
               approximate="tanh")
    out = torch.bmm(h[:, None], params.w_out[ei].float())[:, 0] + params.b_out[ei]
    return (out * gate_top.reshape(-1, 1)).to(x.dtype).reshape(x.shape)
