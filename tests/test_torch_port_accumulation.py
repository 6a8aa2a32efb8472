"""Port parity: gradient accumulation (``--accumulation_steps``, optax's
``MultiSteps`` in ``world_modelz_tpu_torch.train.optim``) against the JAX
package.

The optimizer alone against ``optax.MultiSteps(adamw)`` over six calls
(parameters 1e-6, as tests/test_torch_port_train.py's optimizer test), and
four whole f32 trainer steps at ``accumulation_steps=2`` against the JAX
trainer's step under ``optax.MultiSteps`` (cli/video_diffusion.py:459-460,
537-609) on the same weights, batches and draws (JAX's keys split as its
step splits them): loss and grad norm, parameters, EMA and the sampler at
the whole-step tolerances of tests/test_torch_port_train.py (1e-5; sampler
rtol 1e-6). The EMA and the sampler move at every mini-step; the
parameters, Adam's moments and the schedule's count only at every second.
"""

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

OPT_TOL = 1e-6
STEP_TOL = 1e-5
SAMPLER_RTOL = 1e-6

S, IMG, C, K, D, B = 3, 16, 1, 16, 8, 4
GRID = IMG // 4
TOK_CFG = dict(embedding_dim=D, num_embeddings=K, downscale_steps=2,
               hidden_planes=8, in_channels=C)


def _np(x):
    return np.array(jax.device_get(x))


def _t(x):
    return torch.from_numpy(_np(x))


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_optimizer_matches_optax_multisteps(name):
    """Warmup 1: the first inner update (the second call) runs at lr 0;
    the calls between inner updates leave the parameters as they are."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    sched = jtrain.warmup_cosine_schedule(1e-2, 1, 10)
    jopt = optax.MultiSteps(jtrain.make_optimizer(name, sched, 0.1), 2)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = ptrain.make_optimizer(name, tp.values(), ptrain.warmup_cosine_schedule(1e-2, 1, 10),
                                0.1, accumulation_steps=2)
    for i in range(6):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        before = {k: p.detach().clone() for k, p in tp.items()}
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), _np(jp[k]), rtol=0,
                                       atol=OPT_TOL, err_msg=f"{k}@{i}")
            if i % 2 == 0:  # a mini-step: zero updates
                assert torch.equal(p.detach(), before[k])
        assert opt.count == int(_np(jstate.gradient_step)) == (i + 1) // 2
        assert int(opt.mini_step) == int(_np(jstate.mini_step))


@pytest.fixture(scope="module")
def pair():
    jtok = JaxTokenizer(**TOK_CFG)
    tok_state = jax.jit(jtok.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, C)))
    from world_modelz_tpu_torch.models import VQAutoEncoder

    ptok = VQAutoEncoder(**TOK_CFG, device="cpu")
    ptok.load_state_dict(convert.tokenizer_state_dict_from_state(
        jax.device_get(tok_state.params), jax.device_get(tok_state.batch_stats),
        np.asarray(tok_state.vq.codebook)), strict=True)
    ptok.eval()
    cfg = vd.VideoDiffusionConfig(
        platform="cpu", batch_size=B, n_past=S - 1, image_size=IMG, dim=32,
        depth=2, mlp_dim=24, dim_head=16, heads=2, extents=(1, 1, 1),
        lr=1e-3, weight_decay=1e-2, warmup=1, max_steps=10, ema_decay=0.9,
        p_max_uniform=0.5, eval_interval=0, tok_bf16=False, accumulation_steps=2)
    jm = JaxDenoiser(
        data_shape=(S, GRID, GRID), dim=cfg.dim, num_classes=K,
        extents=cfg.extents, depth=cfg.depth, dim_head=cfg.dim_head,
        mlp_dim=cfg.mlp_dim, heads=cfg.heads, backend="xla")
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, S, GRID, GRID), jnp.int32))["params"])
    return jtok, tok_state, jm, params, ptok, cfg


def _jax_step_fn(jtok, tok_state, jm, cfg):
    """The JAX trainer's step (cli/video_diffusion.py:537-609) with its
    optimizer under optax.MultiSteps (:459-460)."""
    opt = optax.MultiSteps(jtrain.make_optimizer(
        cfg.optimizer, jtrain.warmup_cosine_schedule(cfg.lr, cfg.warmup, cfg.max_steps),
        cfg.weight_decay), cfg.accumulation_steps)

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
        return jguard.reject_nonfinite(ok, old, new), (loss, gn, ok)

    return opt, step


def _port_draws(key, n):
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


def test_four_accumulated_train_steps_match_the_jax_step(pair):
    jtok, tok_state, jm, params, ptok, cfg = pair
    opt, jstep = _jax_step_fn(jtok, tok_state, jm, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = (jp, jtrain.ema_init(jp), opt.init(jp), jtrain.loss_aware_init())
    model = vd.make_model(cfg, (S, GRID, GRID), K, "cpu")
    model.load_state_dict(convert.video_state_dict_from_params(params), strict=True)
    pstate = vd.init_state(cfg, model)
    rng = np.random.default_rng(6)
    for i in range(4):
        frames = rng.integers(0, 256, size=(B, S, IMG, IMG, C)).astype(np.uint8)
        key = jax.random.PRNGKey(100 + i)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        jstate, (loss, gn, ok) = jstep(*jstate, jnp.asarray(frames), key)
        got_loss, got_gn, got_ok = vd.train_step(
            pstate, ptok, torch.from_numpy(frames), cfg, _port_draws(key, GRID * GRID))
        assert got_ok and bool(ok)
        assert abs(got_loss - float(loss)) <= STEP_TOL, (i, got_loss, float(loss))
        assert abs(got_gn - float(gn)) <= STEP_TOL * max(1.0, float(gn))
        jp_, jema, jopt, jsampler = jstate
        want = convert.video_state_dict_from_params(jax.device_get(jp_))
        want_ema = convert.video_state_dict_from_params(jax.device_get(jema))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=STEP_TOL, err_msg=f"{name}@{i}")
            np.testing.assert_allclose(pstate.ema[name].numpy(), want_ema[name].numpy(),
                                       rtol=0, atol=STEP_TOL, err_msg=f"ema {name}@{i}")
            if i % 2 == 0:
                assert torch.equal(p.detach(), before[name]), name
        np.testing.assert_array_equal(pstate.sampler.counts.numpy(), _np(jsampler.counts))
        np.testing.assert_allclose(pstate.sampler.weights.numpy(), _np(jsampler.weights),
                                   rtol=SAMPLER_RTOL)
        assert pstate.optimizer.count == int(_np(jopt.gradient_step)) == (i + 1) // 2
        assert pstate.step == i + 1


def test_trainer_with_accumulation_counts_inner_updates(tmp_path, pair):
    """End to end: 4 steps at accumulation_steps 2 take 2 inner updates;
    a checkpoint holds the accumulator and resumes into the same state."""
    ptok = pair[4]
    tok_path = ptrain.save_checkpoint(str(tmp_path / "tok"), 0,
                                      {"tokenizer": ptok.state_dict()}, TOK_CFG)
    cfg = vd.VideoDiffusionConfig(
        platform="cpu", decoder_model=tok_path, output_dir=str(tmp_path / "run"),
        batch_size=2, n_past=S - 1, image_size=IMG, digit_size=6, dim=32, depth=2,
        mlp_dim=24, dim_head=16, heads=2, extents=(1, 1, 1), warmup=2, max_steps=4,
        eval_interval=0, checkpoint_interval=3, log_interval=2, ema_decay=0.9,
        accumulation_steps=2, steps_per_dispatch=2)
    result = vd.train(cfg)
    assert result.state.step == 4 and result.state.optimizer.count == 2
    assert int(result.state.optimizer.mini_step) == 0
    restored, at, _ = ptrain.restore_checkpoint(str(tmp_path / "run" / "step_0000003"))
    assert at == 3 and int(restored["opt_state"]["mini_step"]) == 1
    assert int(restored["opt_state"]["count"]) == 1
