"""Port parity: the training slice (``world_modelz_tpu_torch.train``,
``diffusion.corrupt_tokens`` and ``cli.video_diffusion``) against the JAX
package, and the port's trainer end to end on the CPU.

Random draws are JAX's: the tests split JAX's keys as the JAX trainer does
and hand the port the resulting Gumbel noise, uniforms and class ids, so
the two must agree. Tolerances: corruption and sampled times exact (the
same float32 arithmetic on the same draws); sampler weights rtol 1e-6 (the
port folds repeated bucket hits in closed form in float64, the JAX package
applies them one by one in float32); schedule 1e-7; optimizer parameters
1e-6 (the same AdamW arithmetic in another operation order); three whole
f32 train steps: loss and parameters within 1e-5 (a 2-layer denoiser's
gradients, as in test_torch_port_attention_bwd.py, then AdamW); one bf16
step: loss and grad norm within 2e-2 relative (bf16 rounds at other places
in the two frameworks).
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu import train as jtrain  # noqa: E402
from world_modelz_tpu.diffusion import masked as jmasked  # noqa: E402
from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.models.video import (  # noqa: E402
    VqVideoDiffusionModel as JaxDenoiser,
)
from world_modelz_tpu.train import guard as jguard  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.diffusion import corrupt_tokens  # noqa: E402
from world_modelz_tpu_torch.models import VQAutoEncoder  # noqa: E402

SAMPLER_RTOL = 1e-6
SCHEDULE_TOL = 1e-7
OPT_TOL = 1e-6
STEP_TOL = 1e-5
BF16_RTOL = 2e-2


def _np(x):
    return np.array(jax.device_get(x))


def _t(x):
    return torch.from_numpy(_np(x))


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("p_max_uniform", [0.1, 0.9])
def test_corrupt_tokens_matches_jax_under_its_draws(p_max_uniform):
    b, n, k = 4, 24, 16
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, k, size=(b, n)).astype(np.int32)
    r = rng.uniform(size=(b,)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want, want_mask = jmasked.corrupt_tokens(
        key, jnp.asarray(tokens), jnp.asarray(r), num_classes=k,
        mask_token=k, p_max_uniform=p_max_uniform)
    k_mask, k_bern, k_uni = jax.random.split(key, 3)
    got, mask = corrupt_tokens(
        torch.from_numpy(tokens), torch.from_numpy(r), num_classes=k,
        mask_token=k, p_max_uniform=p_max_uniform,
        mask_uniform=_t(jax.random.uniform(k_mask, (b, n))),
        resample_uniform=_t(jax.random.uniform(k_bern, (b, n))),
        uniform_classes=_t(jax.random.randint(k_uni, (b, n), 0, k)),
    )
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(mask.numpy(), _np(want_mask))
    assert 0 < int(mask.sum()) < b * n


def _sampler_pair(warm: bool):
    """A JAX sampler state and the port's copy; ``warm``: every bucket past
    its warmup, with uneven weights."""
    js = jtrain.loss_aware_init()
    if warm:
        rng = np.random.default_rng(1)
        js = js.replace(
            weights=jnp.asarray(rng.uniform(0.1, 5.0, 100).astype(np.float32)),
            counts=jnp.full((100,), 11, jnp.int32))
    ps = ptrain.loss_aware_init()
    ps = dataclasses.replace(ps, weights=_t(js.weights), counts=_t(js.counts))
    return js, ps


@pytest.mark.parametrize("warm", [False, True], ids=["uniform", "warmed_up"])
def test_loss_aware_sample_matches_jax_under_its_draws(warm):
    js, ps = _sampler_pair(warm)
    assert bool(ptrain.loss_aware_warmed_up(ps)) == warm
    np.testing.assert_allclose(
        ptrain.loss_aware_weights(ps).numpy(), _np(jtrain.loss_aware_weights(js)),
        rtol=SAMPLER_RTOL)
    key, b = jax.random.PRNGKey(3), 64
    want = jtrain.loss_aware_sample(js, key, b)
    k_bucket, k_jitter = jax.random.split(key)
    got = ptrain.loss_aware_sample(
        ps, b, gumbel=_t(jax.random.gumbel(k_bucket, (b, 100))),
        jitter=_t(jax.random.uniform(k_jitter, (b,))))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    no_jitter = jtrain.loss_aware_sample(js, key, b, jitter=False)
    got = ptrain.loss_aware_sample(
        ps, b, gumbel=_t(jax.random.gumbel(k_bucket, (b, 100))), use_jitter=False)
    np.testing.assert_array_equal(got.numpy(), _np(no_jitter))


def test_loss_aware_update_applies_repeated_hits_in_batch_order():
    js, ps = _sampler_pair(True)
    # buckets 5, 5, 30, 5, 30, 99, 0, 5: repeats in one batch
    ts = np.array([0.05, 0.051, 0.3, 0.0599, 0.305, 0.999, 0.0, 0.055], np.float32)
    losses = np.random.default_rng(2).uniform(0, 8, ts.shape).astype(np.float32)
    want = jtrain.loss_aware_update(js, jnp.asarray(ts), jnp.asarray(losses))
    got = ptrain.loss_aware_update(ps, torch.from_numpy(ts), torch.from_numpy(losses))
    np.testing.assert_array_equal(got.counts.numpy(), _np(want.counts))
    np.testing.assert_allclose(got.weights.numpy(), _np(want.weights), rtol=SAMPLER_RTOL)
    assert got.counts.dtype == torch.int32 and got.weights.dtype == torch.float32


def test_default_draws_come_from_a_generator():
    """Without injected draws, corruption, sampling and the trainer's step
    draws come from a torch.Generator: reproducible and in range."""
    tokens = torch.randint(0, 16, (4, 24), generator=torch.Generator().manual_seed(0))
    r = torch.full((4,), 0.5)
    runs = [corrupt_tokens(tokens, r, num_classes=16, mask_token=16,
                           generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    (c, mask), (c2, _) = runs
    assert torch.equal(c, c2) and torch.equal(c == 16, mask)
    assert 0.2 < float(mask.float().mean()) < 0.8
    t = ptrain.loss_aware_sample(
        ptrain.loss_aware_init(), 64, generator=torch.Generator().manual_seed(2))
    assert t.shape == (64,) and float(t.min()) >= 0 and float(t.max()) < 1
    d = vd.draw_step(torch.Generator().manual_seed(3), 4, 16, 100, 16)
    assert d.gumbel.shape == (4, 100) and bool(torch.isfinite(d.gumbel).all())
    assert d.mask_uniform.shape == d.uniform_classes.shape == (4, 16)
    assert 0 <= int(d.uniform_classes.min()) and int(d.uniform_classes.max()) < 16


@pytest.mark.parametrize("warmup", [0, 5])
def test_warmup_cosine_schedule_matches_optax(warmup):
    total = 20
    want = jtrain.warmup_cosine_schedule(0.5, warmup, total)
    got = ptrain.warmup_cosine_schedule(0.5, warmup, total)
    for step in range(2 * warmup + 10 + (total if warmup == 0 else 0)):
        assert abs(got(step) - float(want(step))) <= SCHEDULE_TOL, step


@pytest.mark.parametrize("name,wd", [("adamw", 0.1), ("adam", 0.0)])
def test_optimizer_matches_optax_over_three_steps(name, wd):
    """Warmup 2: optax evaluates the schedule before counting, so the
    first update runs at lr 0 while the moments move."""
    rng = np.random.default_rng(4)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    jopt = jtrain.make_optimizer(name, jtrain.warmup_cosine_schedule(1e-2, 2, 10), wd)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = ptrain.make_optimizer(
        name, tp.values(), ptrain.warmup_cosine_schedule(1e-2, 2, 10), wd)
    for i, g in enumerate(grads):
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(
                p.detach().numpy(), _np(jp[k]), rtol=0, atol=OPT_TOL, err_msg=f"{k}@{i}")
        if i == 0:  # lr 0: weights unchanged, moments moved
            np.testing.assert_array_equal(tp["a"].detach().numpy(), p0["a"])
    assert opt.count == 3
    with pytest.raises(ValueError):
        ptrain.make_optimizer("sgd", tp.values(), 1e-3)


def test_ema_and_grad_norm_match_jax():
    rng = np.random.default_rng(5)
    ema = {"a": rng.normal(size=(4, 3)).astype(np.float32),
           "b": rng.normal(size=(2,)).astype(np.float32)}
    new = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in ema.items()}
    want = jtrain.ema_update(ema, new, 0.99)
    shadow = ptrain.ema_init({k: torch.from_numpy(v) for k, v in ema.items()})
    got = ptrain.ema_update(shadow, {k: torch.from_numpy(v) for k, v in new.items()}, 0.99)
    assert got is shadow and shadow["a"].data_ptr() != 0
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=0, atol=1e-7)
    gn = ptrain.global_grad_norm([torch.from_numpy(v) for v in new.values()])
    np.testing.assert_allclose(float(gn), float(jtrain.global_grad_norm(new)), rtol=1e-6)


def test_guard_pieces_behave_as_the_jax_guard():
    assert bool(ptrain.tree_all_finite({"a": torch.ones(3), "b": [torch.zeros(2)]}))
    assert not bool(ptrain.tree_all_finite({"a": torch.tensor([1.0, float("nan")])}))
    assert not bool(ptrain.tree_all_finite({"a": torch.tensor([float("inf")])}))
    assert bool(ptrain.tree_all_finite({"a": torch.tensor([1, 2])}))
    old, new = {"w": torch.ones(4)}, {"w": torch.full((4,), 2.0)}
    for ok in (False, True):
        got = ptrain.reject_nonfinite(torch.tensor(ok), old, new)
        want = jguard.reject_nonfinite(jnp.bool_(ok), {"w": jnp.ones(4)},
                                       {"w": jnp.full((4,), 2.0)})
        np.testing.assert_array_equal(got["w"].numpy(), _np(want["w"]))

    # the RestartManager / CheckpointGuard sequence of tests/test_guard.py
    for mgr in (ptrain.RestartManager(max_rejects=3), jguard.RestartManager(max_rejects=3)):
        mgr.record(False)
        mgr.record(False)
        assert not mgr.should_restore()
        mgr.record(False)
        assert mgr.should_restore() and mgr.restores == 1
        assert not mgr.should_restore()
    calls = []
    guard = ptrain.CheckpointGuard(lambda: calls.append(1) or "RESTORED", max_rejects=3)
    for flags in ([True] * 3, [False, False, True, False, False]):
        assert all(guard.record(f) is None for f in flags)
    assert calls == []
    assert guard.record(False) == "RESTORED" and calls == [1]
    assert guard.manager.restores == 1
    assert guard.record(False) is None


def test_checkpoints_complete_only_when_the_config_landed(tmp_path):
    d = str(tmp_path)
    state = {"w": torch.arange(4.0), "nest": {"n": 3, "t": (torch.ones(2), 1.5)}}
    p1 = ptrain.save_checkpoint(d, 1, state, {"lr": 0.1})
    assert ptrain.latest_checkpoint(d) == p1
    os.makedirs(os.path.join(d, "step_0000009"))  # a save cut before its config
    assert ptrain.latest_checkpoint(d) == p1
    restored, step, config = ptrain.restore_checkpoint(p1)
    assert step == 1 and config == {"lr": 0.1}
    torch.testing.assert_close(restored["w"], state["w"])
    assert restored["nest"]["n"] == 3 and restored["nest"]["t"][1] == 1.5
    saver = ptrain.AsyncCheckpointSaver()
    live = {"w": torch.zeros(3)}
    p2 = saver.save(d, 2, live, {"k": 1})
    live["w"] += 5.0  # in place after the snapshot: not in the checkpoint
    saver.wait()
    assert ptrain.latest_checkpoint(d) == p2
    torch.testing.assert_close(ptrain.restore_checkpoint(p2)[0]["w"], torch.zeros(3))


# ------------------------------------------------------ the step, whole

S, IMG, C, K, D, B = 3, 16, 1, 16, 8, 4
GRID = IMG // 4
TOK_CFG = dict(embedding_dim=D, num_embeddings=K, downscale_steps=2,
               hidden_planes=8, in_channels=C)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX tokenizer + denoiser and the port's, on the same weights; the
    port's tokenizer goes through a port tokenizer checkpoint."""
    jtok = JaxTokenizer(**TOK_CFG)
    tok_state = jax.jit(jtok.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, C)))
    path = convert.tokenizer_checkpoint_from_state(
        jax.device_get(tok_state.params), jax.device_get(tok_state.batch_stats),
        np.asarray(tok_state.vq.codebook), TOK_CFG,
        str(tmp_path_factory.mktemp("tok")))
    ptok, config = vd.load_tokenizer(path, "cpu")
    assert config == TOK_CFG and ptok.in_channels == C
    cfg = vd.VideoDiffusionConfig(
        platform="cpu", batch_size=B, n_past=S - 1, image_size=IMG, dim=32,
        depth=2, mlp_dim=24, dim_head=16, heads=2, extents=(1, 1, 1),
        lr=1e-3, weight_decay=1e-2, warmup=2, max_steps=10, ema_decay=0.9,
        p_max_uniform=0.5, eval_interval=0, tok_bf16=False)
    jm = JaxDenoiser(
        data_shape=(S, GRID, GRID), dim=cfg.dim, num_classes=K,
        extents=cfg.extents, depth=cfg.depth, dim_head=cfg.dim_head,
        mlp_dim=cfg.mlp_dim, heads=cfg.heads, backend="xla")
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, S, GRID, GRID), jnp.int32))["params"])
    return jtok, tok_state, jm, params, ptok, cfg


def _jax_step_fn(jtok, tok_state, jm, cfg):
    """The JAX trainer's step, composed from the package's public functions
    as cli/video_diffusion.py:537-609 composes it."""
    opt = jtrain.make_optimizer(
        cfg.optimizer, jtrain.warmup_cosine_schedule(cfg.lr, cfg.warmup, cfg.max_steps),
        cfg.weight_decay)

    @jax.jit
    def step(params, ema, opt_state, sampler, frames, key):
        frames = frames.astype(jnp.float32) / 255.0
        b, s, hh, ww, c = frames.shape
        k_r, k_corrupt, k_drop = jax.random.split(key, 3)
        tokens = jtok.encode(tok_state, frames.reshape(b * s, hh, ww, c))
        tokens = tokens.reshape(b, s, tokens.shape[1], tokens.shape[2])
        target = tokens[:, -1]
        r = jtrain.loss_aware_sample(sampler, k_r, b)
        corrupted, _ = jmasked.corrupt_tokens(
            k_corrupt, target.reshape(b, -1), r, num_classes=K, mask_token=K,
            p_max_uniform=cfg.p_max_uniform)
        batch_z = tokens.at[:, -1].set(corrupted.reshape(target.shape))

        def loss_fn(p):
            if cfg.bf16:
                p = jax.tree_util.tree_map(
                    lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, p)
            logits = jm.apply({"params": p}, batch_z, train=True,
                              rngs={"dropout": k_drop}).astype(jnp.float32)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits.reshape(-1, K), target.reshape(-1))
            return ce.mean(), ce.reshape(b, -1).mean(axis=1)

        (loss, per_sample), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        gn = optax.global_norm(grads)
        old = (params, ema, opt_state, sampler)
        sampler = jtrain.loss_aware_update(sampler, r, jnp.nan_to_num(per_sample))
        grads = jax.tree_util.tree_map(jnp.nan_to_num, grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jtrain.ema_update(ema, params, cfg.ema_decay)
        ok = jnp.isfinite(loss) & jnp.isfinite(gn)
        new = (params, ema, opt_state, sampler)
        return jguard.reject_nonfinite(ok, old, new), (loss, gn, ok, tokens)

    return opt, step


def _port_draws(key, n):
    """JAX's draws of one step, split from its key as step_body splits."""
    k_r, k_corrupt, _ = jax.random.split(key, 3)
    k_bucket, k_jitter = jax.random.split(k_r)
    k_mask, k_bern, k_uni = jax.random.split(k_corrupt, 3)
    return vd.StepDraws(
        gumbel=_t(jax.random.gumbel(k_bucket, (B, 100))),
        jitter=_t(jax.random.uniform(k_jitter, (B,))),
        mask_uniform=_t(jax.random.uniform(k_mask, (B, n))),
        resample_uniform=_t(jax.random.uniform(k_bern, (B, n))),
        uniform_classes=_t(jax.random.randint(k_uni, (B, n), 0, K)),
    )


def _run_both(pair, cfg, steps):
    """``steps`` steps on each side from the same params, batches and
    draws; yields (JAX's state and stats, the port's state and stats)."""
    jtok, tok_state, jm, params, ptok, _ = pair
    opt, jstep = _jax_step_fn(jtok, tok_state, jm, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = (jp, jtrain.ema_init(jp), opt.init(jp), jtrain.loss_aware_init())
    model = vd.make_model(cfg, (S, GRID, GRID), K, "cpu")
    model.load_state_dict(convert.video_state_dict_from_params(params), strict=True)
    pstate = vd.init_state(cfg, model)
    rng = np.random.default_rng(6)
    for i in range(steps):
        frames = rng.integers(0, 256, size=(B, S, IMG, IMG, C)).astype(np.uint8)
        key = jax.random.PRNGKey(100 + i)
        jstate, (loss, gn, ok, jtokens) = jstep(*jstate, jnp.asarray(frames), key)
        ptokens = ptok.encode(torch.from_numpy(frames).float().div(255.0)
                              .reshape(B * S, IMG, IMG, C))
        np.testing.assert_array_equal(ptokens.reshape(B, S, GRID, GRID).numpy(),
                                      _np(jtokens))
        stats = vd.train_step(pstate, ptok, torch.from_numpy(frames), cfg,
                              _port_draws(key, GRID * GRID))
        yield jstate, (float(loss), float(gn), bool(ok)), pstate, stats


def _assert_state_close(jstate, pstate, tol, sampler_rtol=SAMPLER_RTOL):
    jp, jema, _, jsampler = jstate
    want = convert.video_state_dict_from_params(jax.device_get(jp))
    want_ema = convert.video_state_dict_from_params(jax.device_get(jema))
    for name, p in pstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(pstate.ema[name].numpy(), want_ema[name].numpy(),
                                   rtol=0, atol=tol, err_msg=f"ema {name}")
    np.testing.assert_array_equal(pstate.sampler.counts.numpy(), _np(jsampler.counts))
    np.testing.assert_allclose(pstate.sampler.weights.numpy(), _np(jsampler.weights),
                               rtol=sampler_rtol)


def test_three_f32_train_steps_match_the_jax_step(pair):
    cfg = pair[-1]
    for i, (jstate, jstats, pstate, stats) in enumerate(_run_both(pair, cfg, 3)):
        loss, gn, ok = stats
        assert ok and jstats[2]
        assert abs(loss - jstats[0]) <= STEP_TOL, (i, loss, jstats[0])
        assert abs(gn - jstats[1]) <= STEP_TOL * max(1.0, jstats[1]), (i, gn, jstats[1])
        _assert_state_close(jstate, pstate, STEP_TOL)
        assert pstate.step == pstate.optimizer.count == i + 1
        assert int(_np(jstate[2][0].count)) == i + 1  # optax's update count


def test_bf16_train_steps_track_the_jax_step(pair):
    """bf16 compute on f32 masters: the gradients land in f32."""
    cfg = dataclasses.replace(pair[-1], bf16=True)
    for jstate, jstats, pstate, stats in _run_both(pair, cfg, 2):
        loss, gn, ok = stats
        assert ok
        assert abs(loss - jstats[0]) <= BF16_RTOL * abs(jstats[0])
        assert abs(gn - jstats[1]) <= BF16_RTOL * abs(jstats[1])
        assert all(p.dtype == torch.float32 for p in pstate.model.parameters())
        # an Adam step moves a weight by at most ~lr; bf16 may flip the
        # sign of a near-zero gradient, so the masters agree within 2 lr;
        # the sampler's EMA of the per-sample losses within BF16_RTOL
        _assert_state_close(jstate, pstate, 2 * cfg.lr, BF16_RTOL)


def _snapshot(state):
    return copy.deepcopy({"sd": state.state_dict(), "step": state.step,
                          "count": state.optimizer.count})


def _assert_bitwise_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.is_floating_point():  # compare the bits (inf and nan too)
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            a, b = a.contiguous().view(bits), b.contiguous().view(bits)
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bitwise_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_a_nonfinite_step_leaves_the_state_unchanged(pair):
    _, _, _, params, ptok, cfg = pair
    model = vd.make_model(cfg, (S, GRID, GRID), K, "cpu")
    model.load_state_dict(convert.video_state_dict_from_params(params), strict=True)
    state = vd.init_state(cfg, model)
    gen = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (B, S, IMG, IMG, C), generator=gen).to(torch.uint8)
    draw = lambda: vd.draw_step(gen, B, GRID * GRID, 100, K)  # noqa: E731
    assert vd.train_step(state, ptok, frames, cfg, draw())[2]
    with torch.no_grad():
        model.logit_proj.bias[0] = float("inf")
    before = _snapshot(state)
    loss, gn, ok = vd.train_step(state, ptok, frames, cfg, draw())
    assert not ok and not np.isfinite(loss)
    after = _snapshot(state)
    after["step"] -= 1  # the loop's step counts the rejected step
    _assert_bitwise_equal(before, after)


# ------------------------------------------------- the trainer, end to end


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    torch.manual_seed(0)
    tok = VQAutoEncoder(**TOK_CFG, device="cpu")
    return ptrain.save_checkpoint(
        str(tmp_path_factory.mktemp("ptok")), 0, {"tokenizer": tok.state_dict()}, TOK_CFG)


def _tiny(tok_path, out, **kw):
    base = dict(
        platform="cpu", decoder_model=tok_path, output_dir=str(out),
        batch_size=2, n_past=S - 1, image_size=IMG, digit_size=6, dim=32,
        depth=2, mlp_dim=24, dim_head=16, heads=2, extents=(1, 1, 1),
        warmup=2, max_steps=4, eval_interval=0, checkpoint_interval=2,
        log_interval=2, ema_decay=0.9, bf16=True)
    base.update(kw)
    return vd.VideoDiffusionConfig(**base)


def test_train_logs_finite_losses_and_checkpoints(tok_path, tmp_path, capsys):
    result = vd.train(_tiny(tok_path, tmp_path))
    out = capsys.readouterr().out
    logged = [line for line in out.splitlines() if ": loss " in line]
    assert [line.split(":")[0] for line in logged] == ["1", "2", "4"]
    for line in logged:
        assert np.isfinite(float(line.split("loss ")[1].split()[0])), line
        assert "lr " in line and "grad_norm " in line
    assert sorted(os.listdir(tmp_path)) == [
        "step_0000002", "step_0000004", "vq_diffusion_metrics.jsonl"]
    assert ptrain.latest_checkpoint(str(tmp_path)).endswith("step_0000004")
    assert result.state.step == 4 and result.rejected == 0
    assert len(result.history) == 4 and result.token_shape == (S, GRID, GRID)


def test_resume_restores_the_whole_state_exactly(tok_path, tmp_path):
    first = vd.train(_tiny(tok_path, tmp_path, max_steps=2))
    ckpt = os.path.join(str(tmp_path), "step_0000002")
    resumed = vd.train(_tiny(tok_path, tmp_path / "b", max_steps=2, checkpoint=ckpt))
    assert resumed.history == [] and resumed.state.step == 2
    a, b = _snapshot(first.state), _snapshot(resumed.state)
    assert b["count"] == 2
    _assert_bitwise_equal(a, b)
    more = vd.train(_tiny(tok_path, tmp_path / "c", max_steps=4, checkpoint=ckpt))
    assert more.state.step == 4 and more.state.optimizer.count == 4
    assert [h[0] for h in more.history] == [3, 4]
    # weights-only warm start: a fresh optimizer, whose first update runs
    # at lr = schedule(0) = 0 and so leaves the loaded weights as they are
    warm = vd.train(_tiny(tok_path, tmp_path / "d", max_steps=1, init_from=ckpt))
    assert warm.state.step == 1 and warm.state.optimizer.count == 1
    _assert_bitwise_equal(a["sd"]["params"], _snapshot(warm.state)["sd"]["params"])


# the model axes are ported (tests/test_torch_port_{tensor,sequence}_parallel.py):
# on one process an axis of two does not fit the world, which JAX's mesh
# refuses too
UNPORTED = [dict(n_model=2), dict(n_seq=2), dict(fsdp=True, n_model=2)]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(tok_path, tmp_path, kw):
    with pytest.raises(ValueError, match="do not divide the world of 1 processes|"
                                         "must be divisible by n_seq"):
        vd.train(_tiny(tok_path, tmp_path, **kw))


def test_log_fence_modes(tok_path, tmp_path):
    """Both of JAX's modes are accepted (the port logs each step's own
    values in either); another value raises."""
    vd.check_supported(_tiny(tok_path, tmp_path, log_fence="sync"))
    vd.check_supported(_tiny(tok_path, tmp_path, log_fence="deferred"))
    with pytest.raises(ValueError, match="log_fence"):
        vd.train(_tiny(tok_path, tmp_path, log_fence="eager"))


def test_platform_picks_the_device(tok_path, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="platform"):
        vd.train(_tiny(tok_path, tmp_path, platform="tpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vd.train(_tiny(tok_path, tmp_path, platform=""))
