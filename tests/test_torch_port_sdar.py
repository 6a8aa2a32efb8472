"""SDAR's block-diffusion MoE decoder (``models/sdar.py``), its trainer
(``cli/block_diffusion.py``), the dropless held-expert layer
(``parallel/moe.py``), the grouped expert GEMMs' plain versions
(``kernels/expert_gemm.py``) and the block-diffusion mask and its tile walk
(``kernels/dense_attention.py``, ``csrc/bd_mask.cuh``) on the CPU in f32,
against the benchmark's plain reference (``portbench/reference/sdar.py``)
and against a second copy of the layer equations written here."""

import copy
import math
import time

import pytest
import torch
import torch.nn.functional as F

from portbench import loader
from portbench.metrics import bd_counts
from portbench.reference import sdar as ref_sdar
from portbench.reference.precision import Precision
from portbench.runners import train_sdar, training
from world_modelz_tpu_torch.cli import block_diffusion as bdc
from world_modelz_tpu_torch.diffusion import block as bd
from world_modelz_tpu_torch.kernels import dense_attention as da
from world_modelz_tpu_torch.kernels import expert_gemm as eg
from world_modelz_tpu_torch.parallel import moe

# dim 64, 2 layers, 4 query heads over 2 KV heads of 64, 16 experts top-4
# with 4 held, block 4, L 32
TINY = dict(bf16=False, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=64, num_experts=4, router_experts=16,
            num_experts_per_tok=4, moe_intermediate_size=32, vocab_size=64, lr=1e-3)
SEQ, BATCH, BLOCK = 32, 2, 4


def _cfg():
    return dict(loader.config("sdar30b_a3b_ep8"), **TINY)


def _rules(seq_len, block):
    """The mask from its three rules, cell by cell."""
    n = 2 * seq_len
    m = torch.zeros(n, n, dtype=torch.bool)
    for i in range(n):
        for j in range(n):
            bi, bj = (i % seq_len) // block, (j % seq_len) // block
            if i < seq_len:  # noisy: its own block, the clean blocks before it
                m[i, j] = bi == bj if j < seq_len else bj < bi
            else:  # clean: the clean blocks up to its own; never a noisy block
                m[i, j] = j >= seq_len and bj <= bi
    return m


@pytest.mark.parametrize("seq_len,block", [(8, 1), (16, 4), (32, 4), (24, 8), (64, 64)])
def test_mask_predicate_matches_rules(seq_len, block):
    want = _rules(seq_len, block)
    assert torch.equal(da.bd_mask(2 * seq_len, block), want)
    assert torch.equal(ref_sdar.block_mask(seq_len, block, "cpu"), want)
    assert bd_counts.allowed_pairs(seq_len, block) == int(want.sum())


def _q_walk(q0, L):
    """bd_mask.cuh's key tiles of query tile q0: (first key, masked)."""
    t = 64
    steps = q0 // t + 2 if q0 < L else (q0 - L) // t + 1
    out = []
    for s in range(steps):
        if s == 0:
            k0 = q0
        elif q0 < L:
            k0 = L + q0 if s == 1 else L + (s - 2) * t
        else:
            k0 = L + (s - 1) * t
        out.append((k0, s < (2 if q0 < L else 1)))
    return out


def _k_walk(k0, L):
    """bd_mask.cuh's query tiles of key tile k0: (first query, masked)."""
    t = 64
    if k0 < L:
        return [(k0, True)]
    c = k0 - L
    out = [(c, True), (k0, True)]
    for i in range(2 * ((2 * L - k0) // t) - 2):
        tile = c + t * (1 + i // 2)
        out.append((L + tile if i & 1 else tile, False))
    return out


@pytest.mark.parametrize("seq_len,block", [(128, 4), (192, 64), (256, 1), (64, 16)])
def test_tile_walk_covers_the_mask(seq_len, block):
    """Every allowed pair lies in a tile the kernels walk; a tile walked
    without the predicate allows every pair; a walked tile allows some pair
    (but for a block of 64, where a noisy tile's clean tile at its own offset
    is empty); the walks from the query and from the key side are the same
    tiles."""
    n, t = 2 * seq_len, 64
    m = _rules(seq_len, block)
    tiles = {}
    for q0 in range(0, n, t):
        for k0, masked in _q_walk(q0, seq_len):
            assert (q0, k0) not in tiles
            tiles[q0, k0] = masked
    for (q0, k0), masked in tiles.items():
        sub = m[q0:q0 + t, k0:k0 + t]
        assert (sub.any() or block == t) and (masked or sub.all())
    for q0 in range(0, n, t):
        for k0 in range(0, n, t):
            if (q0, k0) not in tiles:
                assert not m[q0:q0 + t, k0:k0 + t].any()
    by_key = {(q0, k0): masked for k0 in range(0, n, t) for q0, masked in _k_walk(k0, seq_len)}
    assert by_key == tiles


def _model_and_weights(seed=3):
    cfg = _cfg()
    bcfg = train_sdar.trainer_config(cfg, {"seq_len": SEQ, "block": BLOCK}, seed,
                                     torch.device("cpu"))
    model = bdc.make_model(bcfg, "cpu")
    w = train_sdar.weights(cfg, seed, "cpu")
    model.load_state_dict(w, strict=True)
    return cfg, bcfg, model, w


def _draws(seed=9):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randint(0, TINY["vocab_size"] - 2, (BATCH, SEQ), generator=g)
    return {"x0": x0, "block_uniform": torch.rand(BATCH, SEQ // BLOCK, generator=g),
            "token_uniform": torch.rand(BATCH, SEQ, generator=g)}


def _equations(w, tokens, cfg, allowed, pos):
    """A second copy of the layer equations in f32: (B, N) tokens at
    positions ``pos`` (N,) under the (N, N) ``allowed`` mask -> the logits
    of every position."""
    eps, dh = cfg["rms_norm_eps"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    k, inter, first = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"], 0

    def norm(x, g):
        return g * x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)

    def rot(x, pos):
        inv = cfg["rope_theta"] ** (-torch.arange(0, dh, 2).float() / dh)
        ang = pos.float()[:, None] * inv
        cos, sin = ang.cos().repeat(1, 2)[:, None], ang.sin().repeat(1, 2)[:, None]
        return x * cos + torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], -1) * sin

    b, n = tokens.shape
    x = w["model.embed_tokens.weight"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = norm(x, w[p + "input_layernorm.weight"])
        q = rot(norm((h @ w[p + "self_attn.q_proj.weight"].t()).view(b, n, hq, dh),
                     w[p + "self_attn.q_norm.weight"]), pos)
        kk = rot(norm((h @ w[p + "self_attn.k_proj.weight"].t()).view(b, n, hkv, dh),
                      w[p + "self_attn.k_norm.weight"]), pos)
        v = (h @ w[p + "self_attn.v_proj.weight"].t()).view(b, n, hkv, dh)
        kk, v = kk.repeat_interleave(hq // hkv, 2), v.repeat_interleave(hq // hkv, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(dh)
        a = torch.softmax(s.masked_fill(~allowed, -math.inf), -1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, n, hq * dh)
        x = x + o @ w[p + "self_attn.o_proj.weight"].t()
        h = norm(x, w[p + "post_attention_layernorm.weight"])
        probs = torch.softmax(h @ w[p + "mlp.gate.weight"].t(), -1)
        top, idx = probs.topk(k, -1)
        top = top / top.sum(-1, keepdim=True)
        y = torch.zeros_like(h)
        for j in range(cfg["num_experts"]):
            wg = w[p + "mlp.experts.gate_up"][j]
            e_out = (F.silu(h @ wg[:inter].t()) * (h @ wg[inter:].t())) @ \
                w[p + "mlp.experts.down"][j].t()
            y = y + e_out * (top * (idx == first + j)).sum(-1, keepdim=True)
        x = x + y
    return norm(x, w["model.norm.weight"]) @ w["lm_head.weight"].t()


def test_model_matches_reference_and_equations():
    """Logits, loss and every gradient of the port against the benchmark's
    reference, and the logits against the equations above."""
    cfg, bcfg, model, w = _model_and_weights()
    d = _draws()
    xt, masked, t = bd.corrupt(d["x0"], d["block_uniform"], d["token_uniform"], BLOCK,
                               TINY["vocab_size"] - 1)
    tokens = bd.layout(xt, d["x0"])
    logits, stats = model(tokens, BLOCK)
    loss = bd.loss(logits, d["x0"], masked, t)
    loss.backward()
    params = {n: p.detach().clone().requires_grad_() for n, p in w.items()}
    ref_logits = ref_sdar.logits(params, tokens, cfg, Precision("f32"))
    ref_loss, _, _ = ref_sdar.TrainStep(cfg, Precision("f32"))(params, d, None)
    ref_loss.backward()
    assert (logits - ref_logits).abs().max().item() < 1e-4
    assert abs(loss.item() - ref_loss.item()) < 1e-5 * ref_loss.item()
    for n, p in model.named_parameters():
        g, rg = p.grad, params[n].grad
        assert (g - rg).abs().max().item() <= 1e-4 * max(rg.abs().max().item(), 1e-6), n
    eq = _equations(w, tokens, cfg, da.bd_mask(2 * SEQ, BLOCK),
                    torch.arange(2 * SEQ) % SEQ)[:, :SEQ]
    assert (logits - eq).abs().max().item() < 1e-4
    assert stats[2].item() == 0 and stats[0].item() > 0


def test_noisy_half_matches_block_by_block():
    """A noisy block's logits equal the model run from scratch on the clean
    blocks before it and the noisy block alone, block-causally."""
    cfg, _, model, w = _model_and_weights()
    d = _draws()
    xt, _, _ = bd.corrupt(d["x0"], d["block_uniform"], d["token_uniform"], BLOCK,
                          TINY["vocab_size"] - 1)
    with torch.no_grad():
        logits, _ = model(bd.layout(xt, d["x0"]), BLOCK)
        for b in range(SEQ // BLOCK):
            lo, hi = b * BLOCK, (b + 1) * BLOCK
            seq = torch.cat([d["x0"][:, :lo], xt[:, lo:hi]], 1)
            blk = torch.arange(hi) // BLOCK
            allowed = blk[None, :] <= blk[:, None]
            out = _equations(w, seq, cfg, allowed, torch.arange(hi))
            assert (logits[:, lo:hi] - out[:, lo:hi]).abs().max().item() < 1e-4, b


def _layer(t=48, d=32, inter=16, e=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, d, generator=g)
    wr = torch.randn(e, d, generator=g)
    w_gu = torch.randn(e, 2 * inter, d, generator=g) * d ** -0.5
    w_d = torch.randn(e, d, inter, generator=g) * inter ** -0.5
    return x, wr, w_gu, w_d


def test_expert_shares_add_up_to_the_layer():
    x, wr, w_gu, w_d = _layer()
    whole, _ = moe.moe_swiglu_held(x, wr, w_gu, w_d, torch.arange(16), 4)
    parts = 0
    for r in range(4):
        held = moe.held_experts(16, r, 4)
        out, plan = moe.moe_swiglu_held(x, wr, w_gu[held], w_d[held], held, 4)
        parts = parts + out
        assert int(plan.placed) == int(plan.counts.sum())
    assert (parts - whole).abs().max().item() < 1e-5


def test_dropless_when_every_token_picks_one_expert():
    """Every token's first choice is expert 5: it receives all T of them,
    nothing is dropped, and each token's output is its experts' sum."""
    x, wr, w_gu, w_d = _layer()
    x = x.abs() + 0.1
    wr[5] = 10.0
    held = moe.held_experts(16, 1, 4)  # experts 4 .. 7
    out, plan = moe.moe_swiglu_held(x, wr, w_gu[held], w_d[held], held, 4)
    assert plan.counts[1].item() == x.shape[0] and int(plan.placed) == int(plan.counts.sum())
    index, weights = moe.route_topk(x @ wr.t(), 4)
    want = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for s in range(4):
            e = int(index[t, s])
            if 4 <= e < 8:
                h = w_gu[e] @ x[t]
                want[t] += weights[t, s] * (w_d[e] @ (F.silu(h[:16]) * h[16:]))
    assert (out - want).abs().max().item() < 1e-5


def test_grouped_gemm_plain_matches_per_expert_matmul():
    g = torch.Generator().manual_seed(2)
    counts = [5, 0, 130, 17]
    padded = [-(-c // eg.ROW_TILE) * eg.ROW_TILE for c in counts]
    offsets = torch.tensor([0] + list(torch.tensor(padded).cumsum(0)), dtype=torch.int32)
    rows, d, inter = int(offsets[-1]), 24, 8
    x = torch.zeros(rows, d)
    for e, c in enumerate(counts):
        x[int(offsets[e]):int(offsets[e]) + c] = torch.randn(c, d, generator=g)
    w_gu = torch.randn(4, 2 * inter, d, generator=g)
    w_d = torch.randn(4, d, inter, generator=g)
    gu, act = eg.swiglu_fwd(x, w_gu, offsets)
    y = eg.rows_nt(act, w_d, offsets)
    dy = torch.randn(rows, d, generator=g) * (x.abs().sum(1, keepdim=True) > 0)
    dgu = eg.swiglu_bwd(dy, w_d, gu, offsets)
    for e in range(4):
        r = slice(int(offsets[e]), int(offsets[e + 1]))
        h = x[r] @ w_gu[e].t()
        a = F.silu(h[:, :inter]) * h[:, inter:]
        assert torch.allclose(gu[r], h, atol=1e-5) and torch.allclose(act[r], a, atol=1e-5)
        assert torch.allclose(y[r], a @ w_d[e].t(), atol=1e-4)
        da_ = dy[r] @ w_d[e]
        sig = torch.sigmoid(h[:, :inter])
        dg = da_ * h[:, inter:] * sig * (1 + h[:, :inter] * (1 - sig))
        assert torch.allclose(dgu[r], torch.cat([dg, da_ * F.silu(h[:, :inter])], 1), atol=1e-4)
        assert torch.allclose(eg.rows_nn(dgu, w_gu, offsets)[r], dgu[r] @ w_gu[e], atol=1e-4)
        assert torch.allclose(eg.wgrad(dgu, x, offsets)[e], dgu[r].t() @ x[r], atol=1e-4)


def test_trainer_runs_tiny(tmp_path):
    cfg = bdc.BlockDiffusionConfig(
        platform="cpu", batch_size=2, seq_len=32, vocab=64, dim=64, depth=2, heads=4,
        kv_heads=2, head_dim=16, expert_dim=32, num_experts=16, top_k=4, held_experts=4,
        max_steps=4, log_interval=2, steps_per_dispatch=2, lr=1e-3, bf16=False,
        output_dir=str(tmp_path))
    state, history, _ = bdc.train(cfg)
    assert [h[0] for h in history] == [1, 2, 3, 4] and all(h[3] for h in history)
    assert history[-1][1] < history[0][1]


def test_runner_tiny_controls_and_faults_fail():
    """The benchmark's runner on the CPU at the tiny size: the program
    agrees with the reference, and the reference in the program's place in
    fp8, on half the batch, with top-7 routing, with capacity 1.0 or with
    the noisy blocks seeing each other fails a number of the cell's
    limits."""
    cell = copy.deepcopy(loader.workload("sdar30b_a3b_ep8.train_bd_b8"))
    cell["traffic"].update(batch_size=BATCH, seq_len=SEQ, warmup_seconds=0.1,
                           trace_seconds=0.1)
    res = train_sdar.run(cell, _cfg(), seed=5000000001, seconds=0.2, trace=False,
                         t0=time.perf_counter(), device="cpu",
                         variants={"control": {"precision": "fp8"},
                                   "half_batch": {"fraction": 0.5}})
    gaps = training.compare(res["program"], res["reference"])
    assert res["correct"] and gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4
    limits = cell["limits"]
    assert set(res["variants"]) == {"control", "half_batch", "top7", "capacity_1",
                                    "noisy_bidirectional"}
    for name, numbers in res["variants"].items():
        assert any(numbers[n] > float(v) for n, v in limits.items()), (name, numbers)
