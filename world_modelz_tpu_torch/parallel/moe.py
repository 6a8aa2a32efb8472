"""Mixture-of-experts FFN with capacity-based top-1 routing.

Port of ``world_modelz_tpu.parallel.moe``. The routing is JAX's:

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

Expert sharding (``expert_shardings``, JAX's; ``DEFAULT_TP_RULES`` put the
expert axis over ``model``): each model rank holds E / n_model experts
(``local_experts``). The tokens and the router are the same on every
model rank; ``moe_ffn_indexed`` with ``tp`` computes the outputs of the
rank's experts and one all-reduce combines them. A token has one expert,
so the f32 sum is its output plus zeros: exact, the unsharded values bit
for bit. The gate's product, and so the router's gradient, follows the
sum on every rank alike; the tokens' gradient through the experts is
summed over the ranks (``copy_to``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from world_modelz_tpu_torch.parallel.distributed import (
    all_reduce_mean,
    copy_to,
    global_value,
    reduce_from,
)
from world_modelz_tpu_torch.parallel.mesh import Mesh


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


def load_balance_loss(gate: torch.Tensor, expert: torch.Tensor,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """E * sum_e mean(sel_e) * mean(gate_e) over the (B, N) tokens; with a
    ``mesh``, both means are the global batch's (JAX's global view,
    parallel/moe.py:121-124): reduced over its data axis before their
    product, the gate's keeping this rank's share of the gradient."""
    e = gate.shape[-1]
    mesh = mesh or Mesh()
    sel = F.one_hot(expert, e).to(gate.dtype)
    density = all_reduce_mean(sel.mean((0, 1)), mesh)
    proxy = global_value(gate.mean((0, 1)), mesh)
    return torch.sum(density * proxy) * e


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
    params: MoEParams, x: torch.Tensor, *, capacity: int, mesh: Optional[Mesh] = None
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
    return y, load_balance_loss(gate, expert, mesh)


def moe_ffn_indexed(
    params: MoEParams, x: torch.Tensor, *, capacity: int, mesh: Optional[Mesh] = None,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` with the tokens moved by index (the main path): the same
    result, without the (B, N, E, C) tensors. Capacity is per batch row, so
    under data parallelism dispatch stays on the rank; only the
    load-balance term's means cross the ``mesh``. With ``tp`` (a model
    ``Axis``) ``params`` holds this rank's experts (``local_experts``) and
    the whole router."""
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
    # this rank's experts [lo, lo + e_loc) (all of them without tp)
    e_loc = params.w_in.shape[0]
    lo = 0 if tp is None else tp.index * e_loc
    mine = slice(lo * capacity, (lo + e_loc) * capacity)
    table = table[:, mine]
    xin = torch.cat([copy_to(x, tp).float(), x.new_zeros((b, 1, d), dtype=torch.float32)],
                    dim=1)
    expert_in = xin.gather(1, table[..., None].expand(b, e_loc * capacity, d))
    expert_in = expert_in.view(b, e_loc, capacity, d).transpose(0, 1)
    expert_out = _experts(params, expert_in.contiguous())  # (E_loc, B, C, D)
    out = torch.cat([expert_out.transpose(0, 1).reshape(b, e_loc * capacity, d),
                     expert_out.new_zeros((b, 1, d))], dim=1)
    # a dropped token, and one of another rank's experts, reads the
    # appended zero row
    held = keep & (flat >= mine.start) & (flat < mine.stop)
    picked = out.gather(1, torch.where(held, flat - mine.start, e_loc * capacity)[
        ..., None].expand(b, n, d))
    y = (reduce_from(picked, tp) * gate_top[..., None]).to(x.dtype)
    return y, load_balance_loss(gate, expert, mesh)


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


def expert_shardings() -> MoEParams:
    """The dimension of each ``MoEParams`` leaf that expert sharding splits
    over the model axis (JAX's ``expert_shardings``: the expert axis; the
    router replicated, None)."""
    return MoEParams(w_gate=None, w_in=0, b_in=0, w_out=0, b_out=0)


def local_experts(params: MoEParams, index: int, size: int) -> MoEParams:
    """Model rank ``index`` of ``size``'s share of ``params``: E / size
    consecutive experts and the whole router."""
    e = params.w_in.shape[0]
    if e % size:
        raise ValueError(f"{e} experts do not split over {size} model ranks")
    lo, hi = index * e // size, (index + 1) * e // size
    return MoEParams(*(t if dim is None else t[lo:hi]
                       for t, dim in zip(params, expert_shardings())))


# ----------------------------------------------------------------------
# Dropless top-k routing for an expert layer that holds some of the
# experts (SDAR, models/sdar.py): the router sees all of them, the layer
# computes its held experts' part of the output for every token routed to
# them, with no capacity and no dropped token. On one card it runs without
# its exchange; under expert parallelism each model rank would hold
# ``held_experts(E, rank, ranks)`` and its partial outputs would be summed
# over the model axis. The expert products are the grouped bf16 kernels of
# ``kernels/expert_gemm.py`` (plain versions on the CPU), over rows grouped
# by expert and padded to ``expert_gemm.ROW_TILE`` in a buffer of static
# size: nothing is read on the host, so a step captures in a CUDA graph.


def held_experts(num_experts: int, index: int, size: int) -> torch.Tensor:
    """The experts model rank ``index`` of ``size`` holds: E / size
    consecutive ones, as ``local_experts`` cuts them."""
    if num_experts % size:
        raise ValueError(f"{num_experts} experts do not split over {size} model ranks")
    return torch.arange(index * num_experts // size, (index + 1) * num_experts // size)


def route_topk(logits: torch.Tensor, k: int, normalise: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 softmax over every expert, its top ``k`` (indices (T, k)
    int64, the first of equal values first) and their weights (T, k) f32,
    renormalised to sum to 1 with ``normalise`` (``norm_topk_prob``)."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, index = torch.topk(probs, k, dim=-1)
    if normalise:
        weights = weights / weights.sum(-1, keepdim=True)
    return index, weights


def held_rows(tokens: int, k: int, held: int) -> int:
    """Rows of the static grouped buffer: every assignment of ``tokens``
    tokens could go to a held expert (at most min(k, held) a token), each
    expert's group padded to the kernels' tile."""
    from world_modelz_tpu_torch.kernels.expert_gemm import ROW_TILE

    need = tokens * min(k, held) + held * (ROW_TILE - 1)
    return -(-need // ROW_TILE) * ROW_TILE


class HeldPlan(NamedTuple):
    """Where the held experts' assignments go in the grouped buffer.

    offsets:  (E_held + 1,) int32 padded group starts (the kernels').
    token:    (rows_max,) int64 each row's token (T: a padding row).
    assign:   (rows_max,) int64 each row's assignment, token * k + slot
              (T k: a padding row).
    counts:   (E_held,) int64 assignments each held expert received.
    placed:   () int64 assignments placed in the buffer (all held ones).
    """

    offsets: torch.Tensor
    token: torch.Tensor
    assign: torch.Tensor
    counts: torch.Tensor
    placed: torch.Tensor


def held_plan(index: torch.Tensor, held: torch.Tensor, num_experts: int) -> HeldPlan:
    """The grouping of the (T, k) assignments ``index`` to the held experts
    (global ids ``held``, their local order the buffer's), on the device:
    a stable sort by held expert, each group starting at its padded
    offset."""
    from world_modelz_tpu_torch.kernels.expert_gemm import ROW_TILE

    t, k = index.shape
    e = held.shape[0]
    dev = index.device
    lut = torch.full((num_experts,), e, dtype=torch.long, device=dev)
    lut[held.to(dev)] = torch.arange(e, device=dev)
    bucket = lut[index.reshape(-1)]  # E_held: not held here
    n = bucket.shape[0]
    counts = torch.zeros(e + 1, dtype=torch.long, device=dev).scatter_add_(
        0, bucket, torch.ones_like(bucket))
    padded = (counts[:e] + ROW_TILE - 1) // ROW_TILE * ROW_TILE
    offsets = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)])
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    order = torch.argsort(bucket, stable=True)
    sorted_bucket = bucket[order]
    rows = held_rows(t, k, e)
    rank = torch.arange(n, device=dev) - starts[sorted_bucket]
    dest = torch.where(sorted_bucket < e, offsets[sorted_bucket.clamp(max=e - 1)] + rank, rows)
    token = torch.full((rows + 1,), t, dtype=torch.long, device=dev)
    token.scatter_(0, dest, order // k)
    assign = torch.full((rows + 1,), n, dtype=torch.long, device=dev)
    assign.scatter_(0, dest, order)
    token, assign = token[:rows], assign[:rows]
    return HeldPlan(offsets.to(torch.int32), token, assign, counts[:e],
                    (token < t).sum())


class HeldExperts(torch.autograd.Function):
    """The held experts' weighted SwiGLU outputs, summed per token in f32
    and rounded to x's dtype: sum over a token's held assignments of w
    down(silu(gate(x)) up(x)). Saves x, the plan and the weights; the
    backward recomputes the expert products (the grouped buffers are not
    kept between the passes)."""

    @staticmethod
    def forward(ctx, x, weights, w_gu, w_down, token, assign, offsets):
        from world_modelz_tpu_torch.kernels import expert_gemm as eg

        n = weights.numel()
        # each (token, slot)'s row, -1 where the expert is not held here
        row_of = torch.full((n + 1,), -1, dtype=torch.long, device=x.device)
        row_of.scatter_(0, assign, torch.arange(assign.shape[0], device=x.device))
        row_of = row_of[:n].view(weights.shape)
        xp = eg.gather_rows(x, token, offsets)
        _, act = eg.swiglu_fwd(xp, w_gu, offsets)
        del xp
        out = eg.combine_rows(eg.rows_nt(act, w_down, offsets), row_of, weights)
        ctx.save_for_backward(x, weights, w_gu, w_down, token, assign, offsets, row_of)
        return out

    @staticmethod
    def backward(ctx, dout):
        from world_modelz_tpu_torch.kernels import expert_gemm as eg

        x, weights, w_gu, w_down, token, assign, offsets, row_of = ctx.saved_tensors
        xp = eg.gather_rows(x, token, offsets)
        gu, act = eg.swiglu_fwd(xp, w_gu, offsets)
        y = eg.rows_nt(act, w_down, offsets)
        w_row = torch.cat([weights.reshape(-1), weights.new_zeros(1)])[assign]
        dy, dw_row = eg.scatter_rows_bwd(dout.to(x.dtype).contiguous(), y, token, w_row,
                                         offsets)
        del y
        dgu = eg.swiglu_bwd(dy, w_down, gu, offsets)
        del gu
        d_down = eg.wgrad(dy, act, offsets)
        del dy, act
        dx = eg.combine_rows(eg.rows_nn(dgu, w_gu, offsets), row_of)
        d_gu = eg.wgrad(dgu, xp, offsets)
        dweights = torch.zeros(weights.numel() + 1, dtype=torch.float32, device=x.device)
        dweights.index_copy_(0, assign, dw_row)
        dweights = dweights[:-1].reshape(weights.shape).to(weights.dtype)
        return dx, dweights, d_gu, d_down, None, None, None


def moe_swiglu_held(x: torch.Tensor, w_router: torch.Tensor, w_gu: torch.Tensor,
                    w_down: torch.Tensor, held: torch.Tensor, k: int,
                    normalise: bool = True) -> Tuple[torch.Tensor, HeldPlan]:
    """The held experts' part of a dropless top-``k`` SwiGLU expert layer
    (Qwen3-MoE's block): router logits x W_r^T in f32 (the operands as
    given, the sums unrounded: a bf16 rounding of the logits ties experts),
    the f32 softmax over all E experts and its top k (``route_topk``); each token
    through each of its selected held experts ``held`` (w_gu (E_held, 2 I,
    D): gate rows then up rows; w_down (E_held, D, I)), weighted and summed
    in f32, then cast to x's dtype. x is (T, D); returns (out (T, D), the
    plan: counts and placed assignments for the layer's statistics)."""
    logits = F.linear(x.float(), w_router.float())
    index, weights = route_topk(logits, k, normalise)
    plan = held_plan(index, held, w_router.shape[0])
    out = HeldExperts.apply(x, weights, w_gu, w_down, plan.token, plan.assign, plan.offsets)
    return out, plan
