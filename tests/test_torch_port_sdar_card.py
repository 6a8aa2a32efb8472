"""On the card: the block-diffusion GQA kernels (``bdflash_*``) and the grouped
expert GEMMs (``expert_gemm_*``) against their plain versions, fed the same
bf16 operands. Marked ``chip``; skips without a CUDA card. On the card:
``python -m pytest tests/test_torch_port_sdar_card.py --noconftest -m chip -q``.

Tolerances. The attention kernels round P (and dS) to bf16 at other points
than the plain versions (the forward against the running max of its key
walk, the plain version after the softmax) and sum in another order: each
output within 2^-6 of its largest magnitude. The expert GEMMs sum the same
bf16 products in f32 in another order and round once: within 2^-7 of the
largest magnitude (a bf16 rounding step is 2^-8 of the value). Each row
(the last axis) is held to the same share of its own norm, floored at a
thousandth of the rows' rms norm, so that a wrong tile walk or a wrong
query group shows in the rows it touches.
"""

import pytest
import torch

from world_modelz_tpu_torch.kernels import dense_attention as da
from world_modelz_tpu_torch.kernels import expert_gemm as eg
from world_modelz_tpu_torch.parallel import moe

pytestmark = pytest.mark.chip


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, frac):
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= frac * scale, (err, scale)
    rows_got, rows_want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    norm = torch.linalg.vector_norm(rows_want, dim=1)
    floor = 1e-3 * norm.square().mean().sqrt().clamp_min(1e-30)
    rel = torch.linalg.vector_norm(rows_got - rows_want, dim=1) / norm.clamp_min(floor)
    assert rel.max().item() <= frac, (rel.max().item(), int(rel.argmax()))


@pytest.mark.parametrize("shape", [(1, 32, 4, 256, 4), (2, 8, 2, 128, 2), (1, 4, 4, 192, 64)])
def test_bdflash_matches_plain(card, shape):
    b, hq, hkv, seq_len, block = shape
    n = 2 * seq_len
    gen = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(b, n, hq, 128, generator=gen, device=card).to(torch.bfloat16)
    k = torch.randn(b, n, hkv, 128, generator=gen, device=card).to(torch.bfloat16)
    v = torch.randn(b, n, hkv, 128, generator=gen, device=card).to(torch.bfloat16)
    g = torch.randn(b, n, hq, 128, generator=gen, device=card).to(torch.bfloat16)
    q, k, v, g = (t.transpose(1, 2) for t in (q, k, v, g))
    scale = 128 ** -0.5
    out, lse = da.bd_attention_fwd(q, k, v, block, scale)
    ref, ref_lse = da.bd_attention_fwd_plain(q, k, v, block, scale)
    _close(out, ref, 2 ** -6)
    assert (lse - ref_lse).abs().max().item() < 1e-3
    dq, delta = da.bd_bwd_dq(q, k, v, out, g, lse, block, scale)
    rdq, rdelta = da.bd_bwd_dq_plain(q, k, v, out, g, lse, block, scale)
    _close(dq, rdq, 2 ** -6)
    _close(delta, rdelta, 2 ** -10)
    dk, dv = da.bd_bwd_dkv(q, k, v, g, lse, delta, block, scale)
    rdk, rdv = da.bd_bwd_dkv_plain(q, k, v, g, lse, delta, block, scale)
    _close(dk, rdk, 2 ** -6)
    _close(dv, rdv, 2 ** -6)
    again, _ = da.bd_attention_fwd(q, k, v, block, scale)
    assert torch.equal(out, again)


def _grouped(card, e=4, t=700, k=4, d=256, inter=256):
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(t, d, generator=gen, device=card).to(torch.bfloat16)
    logits = torch.randn(t, 4 * e, generator=gen, device=card)
    index, weights = moe.route_topk(logits, k)
    plan = moe.held_plan(index, moe.held_experts(4 * e, 1, 4), 4 * e)
    xp = torch.cat([x, x.new_zeros(1, d)])[plan.token]
    w_gu = (torch.randn(e, 2 * inter, d, generator=gen, device=card) * d ** -0.5).to(torch.bfloat16)
    w_d = (torch.randn(e, d, inter, generator=gen, device=card) * inter ** -0.5).to(torch.bfloat16)
    return xp, w_gu, w_d, plan


def test_expert_gemm_matches_plain(card):
    xp, w_gu, w_d, plan = _grouped(card)
    cpu = [t.cpu() for t in (xp, w_gu, w_d, plan.offsets)]
    gu, act = eg.swiglu_fwd(xp, w_gu, plan.offsets)
    rgu, ract = eg.swiglu_fwd(cpu[0], cpu[1], cpu[3])
    used = int(plan.offsets[-1])
    _close(gu[:used], rgu[:used], 2 ** -7)
    _close(act[:used], ract[:used], 2 ** -7)
    y = eg.rows_nt(act, w_d, plan.offsets)
    _close(y[:used], eg.rows_nt(ract, cpu[2], cpu[3])[:used], 2 ** -7)
    dy = y.clone()
    dgu = eg.swiglu_bwd(dy, w_d, gu, plan.offsets)
    _close(dgu[:used], eg.swiglu_bwd(dy.cpu(), cpu[2], rgu, cpu[3])[:used], 2 ** -6)
    dx = eg.rows_nn(dgu, w_gu, plan.offsets)
    _close(dx[:used], eg.rows_nn(dgu.cpu(), cpu[1], cpu[3])[:used], 2 ** -7)
    _close(eg.wgrad(dgu, xp, plan.offsets), eg.wgrad(dgu.cpu(), cpu[0], cpu[3]), 2 ** -7)
    _close(eg.wgrad(dy, act, plan.offsets), eg.wgrad(dy.cpu(), act.cpu(), cpu[3]), 2 ** -7)


def test_held_experts_layer_matches_cpu(card):
    """The dropless layer's experts, forward and backward, on the card against
    the CPU's plain run of the same bf16 operands and the same routing (the
    router's bf16 product may break a near tie otherwise on each side)."""
    gen = torch.Generator(device=card).manual_seed(5)
    t, d, inter, e = 1000, 256, 128, 16
    x = torch.randn(t, d, generator=gen, device=card).to(torch.bfloat16)
    w_gu = (torch.randn(4, 2 * inter, d, generator=gen, device=card) * d ** -0.5).to(torch.bfloat16)
    w_d = (torch.randn(4, d, inter, generator=gen, device=card) * inter ** -0.5).to(torch.bfloat16)
    g = torch.randn(t, d, generator=gen, device=card).to(torch.bfloat16)
    index, weights = moe.route_topk(torch.randn(t, e, generator=gen, device=card), 4)
    held = moe.held_experts(e, 2, 4)
    outs = []
    for dev in (card, torch.device("cpu")):
        plan = moe.held_plan(index.to(dev), held, e)
        assert int(plan.counts.sum()) == int(plan.placed)
        leaves = [z.detach().to(dev).requires_grad_() for z in (x, weights, w_gu, w_d)]
        out = moe.HeldExperts.apply(*leaves, plan.token, plan.assign, plan.offsets)
        out.backward(g.to(dev))
        outs.append([out] + [z.grad for z in leaves])
    for got, want in zip(*outs):
        _close(got, want, 2 ** -6)


def test_expert_rows_match_plain(card):
    """The row moves around the grouped GEMMs against their plain versions:
    the gather exactly; the f32 sums (which the kernels may fuse into
    multiply-adds) within a bf16 rounding step of the largest magnitude."""
    xp, _, _, plan = _grouped(card)
    gen = torch.Generator(device=card).manual_seed(11)
    t, d, k = 700, 256, 4
    x = torch.randn(t, d, generator=gen, device=card).to(torch.bfloat16)
    used = int(plan.offsets[-1])
    got = eg.gather_rows(x, plan.token, plan.offsets)
    want = eg.gather_rows(x.cpu(), plan.token.cpu(), plan.offsets.cpu())
    assert torch.equal(got[:used].cpu(), want[:used])
    row_of = torch.full((t * k + 1,), -1, dtype=torch.long, device=card)
    row_of.scatter_(0, plan.assign, torch.arange(plan.assign.shape[0], device=card))
    row_of = row_of[:-1].view(t, k)
    w = torch.rand(t, k, generator=gen, device=card)
    y = torch.randn(xp.shape, generator=gen, device=card).to(torch.bfloat16)
    _close(eg.combine_rows(y, row_of, w), eg.combine_rows(y.cpu(), row_of.cpu(), w.cpu()),
           2 ** -8)
    w_row = torch.cat([w.reshape(-1), w.new_zeros(1)])[plan.assign]
    dy, dw = eg.scatter_rows_bwd(x, y, plan.token, w_row, plan.offsets)
    rdy, rdw = eg.scatter_rows_bwd(x.cpu(), y.cpu(), plan.token.cpu(), w_row.cpu(),
                                   plan.offsets.cpu())
    assert torch.equal(dy[:used].cpu(), rdy[:used])
    _close(dw[:used], rdw[:used], 2 ** -16)
