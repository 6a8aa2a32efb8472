"""Port parity: the sparse space-time diffusion slice
(``models.video.VqSparseDiffusionModel``, ``diffusion.sparse``,
``train.uniform_sample``, ``data.BufferedTrajectorySampler``,
``convert.sparse_state_dict_from_params`` and ``cli.sparse_diffusion``)
against the JAX package, and the port's trainer end to end on the CPU.

Random draws are JAX's: the tests split JAX's keys as the JAX functions
split them and hand the port the resulting uniforms, permutations and
Gumbel noise, so positions, token volumes and corrupted tokens must be
equal. Tolerances: the bridge exact; logits 1e-5 and parameter gradients
1e-5 times max(1, max |grad|) (f32 sums in another order); three whole f32
train steps: loss, grad norm, parameters, EMA and Adam's first moment
1e-5, its second moment 1e-5 of its largest value, the sampler's weights
rtol 1e-6 (as tests/test_torch_port_train.py); clips exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu import train as jtrain  # noqa: E402
from world_modelz_tpu.data.trajectory import (  # noqa: E402
    BufferedTrajectorySampler as JaxSampler,
    SyntheticTrajectorySource as JaxSource,
)
from world_modelz_tpu.diffusion import masked as jmasked  # noqa: E402
from world_modelz_tpu.diffusion import sparse as jsparse  # noqa: E402
from world_modelz_tpu.models.video import (  # noqa: E402
    VqSparseDiffusionModel as JaxSparseModel,
)
from world_modelz_tpu.train import guard as jguard  # noqa: E402
from world_modelz_tpu.utils.torch_import import sparse_params_from_torch  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.data import (  # noqa: E402
    BufferedTrajectorySampler,
    SyntheticTrajectorySource,
)
from world_modelz_tpu_torch.diffusion import sparse as psparse  # noqa: E402
from world_modelz_tpu_torch.models import (  # noqa: E402
    VQAutoEncoder,
    VqSparseDiffusionModel,
)

TOL = 1e-5
SAMPLER_RTOL = 1e-6

SHAPE = (4, 4, 4)  # (S, H, W)
VOLUME = 64
N_CTX = 24
K = 16
MODEL = dict(dim=32, num_classes=K, depth=2, dim_head=16, mlp_dim=24, heads=2)


def _np(x):
    return np.array(jax.device_get(x))


def _t(x):
    return torch.from_numpy(_np(x))


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxSparseModel(shape=SHAPE, attn_backend="xla", **MODEL)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, N_CTX), jnp.int32),
        jnp.zeros((1, N_CTX), jnp.int32))["params"])
    return jm, params


def _tree_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_sparse_bridge_round_trips_and_loads_strict(jax_model):
    _, params = jax_model
    state = convert.sparse_state_dict_from_params(params)
    _tree_equal(sparse_params_from_torch(state), params)
    model = VqSparseDiffusionModel(SHAPE, device="cpu", **MODEL)
    model.load_state_dict(state, strict=True)
    assert model.embedding.weight.shape == (K + 1, MODEL["dim"])
    # mixture-of-experts FFNs: flax's MoEFeedForward_{i} arrays, as they are
    jm = JaxSparseModel(shape=SHAPE, attn_backend="xla", moe_experts=2, **MODEL)
    moe_params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, N_CTX), jnp.int32),
        jnp.zeros((1, N_CTX), jnp.int32))["params"])
    moe_state = convert.sparse_state_dict_from_params(moe_params)
    moe_model = VqSparseDiffusionModel(SHAPE, device="cpu", moe_experts=2, **MODEL)
    moe_model.load_state_dict(moe_state, strict=True)
    for name in ("w_gate", "w_in", "b_in", "w_out", "b_out"):
        np.testing.assert_array_equal(
            moe_state[f"transformer.layers.1.1.fn.{name}"].numpy(),
            moe_params["transformer"]["MoEFeedForward_1"][name])


def _inputs(seed, b=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, K + 1, size=(b, N_CTX)).astype(np.int32)
    indices = np.stack([rng.permutation(VOLUME)[:N_CTX] for _ in range(b)]).astype(np.int32)
    return tokens, indices


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_sparse_model_logits_and_gradients_match_jax(jax_model, backend):
    jm, params = jax_model
    tokens, indices = _inputs(1)
    w = np.random.default_rng(2).normal(size=(3, N_CTX, K)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, tokens, indices) * w)

    want = _np(jm.apply({"params": params}, tokens, indices))
    grads = convert.sparse_state_dict_from_params(jax.device_get(jax.grad(loss)(params)))
    model = VqSparseDiffusionModel(SHAPE, attn_backend=backend, device="cpu", **MODEL)
    model.load_state_dict(convert.sparse_state_dict_from_params(params), strict=True)
    got = model(torch.from_numpy(tokens), torch.from_numpy(indices))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL)
    (got * torch.from_numpy(w)).sum().backward()
    for name, p in model.named_parameters():
        g = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(g).max())),
                                   err_msg=name)


# ------------------------------------------------------------- samplers


def test_sample_flat_positions_matches_jax_under_its_draws():
    key, b = jax.random.PRNGKey(3), 5
    want = jsparse.sample_flat_positions(key, b, N_CTX, VOLUME)
    u = np.stack([_np(jax.random.uniform(k, (VOLUME,))) for k in jax.random.split(key, b)])
    got = psparse.sample_flat_positions(b, N_CTX, VOLUME, uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert all(len(set(row)) == N_CTX for row in got.tolist())


@pytest.mark.parametrize("given_offsets", [False, True])
def test_sample_time_dependent_matches_jax_under_its_draws(given_offsets):
    b = 16
    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(5)
    # the corners: t at 0 and 1, offsets at 0 and past 1 - 1e-5 (clipped)
    t = np.concatenate([[0.0, 1.0, 0.5, 0.999999], rng.uniform(size=b - 4)]).astype(np.float32)
    o = None
    if given_offsets:
        o = np.concatenate([[0.0, 1.0, 0.99999, 0.5], rng.uniform(size=b - 4)]).astype(np.float32)
    want = jsparse.sample_time_dependent(
        key, b, N_CTX, SHAPE, jnp.asarray(t), None if o is None else jnp.asarray(o))
    k_o, k_perm = jax.random.split(key)
    got = psparse.sample_time_dependent(
        b, N_CTX, SHAPE, torch.from_numpy(t),
        None if o is None else torch.from_numpy(o),
        offset_uniform=_t(jax.random.uniform(k_o, (b,))),
        uniforms=_t(jax.random.uniform(k_perm, (b, VOLUME))))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert int(got.min()) >= 0 and int(got.max()) < VOLUME


def test_uniform_sample_matches_jax():
    key = jax.random.PRNGKey(6)
    want = jtrain.uniform_sample(key, 7)
    got = ptrain.uniform_sample(7, uniforms=_t(jax.random.uniform(key, (7,))))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    drawn = ptrain.uniform_sample(7, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (7,) and 0 <= float(drawn.min()) and float(drawn.max()) < 1


class JaxDraws:
    """The sweep's draws, split from JAX's key as sparse_denoise_volume
    splits it (diffusion/sparse.py:152-199)."""

    def __init__(self, key, b, num_classes, sampling_type):
        self.key, self.b, self.k = key, b, num_classes
        self.sampling_type = sampling_type
        self.offset_count = VOLUME // N_CTX + 1

    def iteration(self, i):
        self.key, k_perm, k_order, _ = jax.random.split(self.key, 4)
        perm = jax.vmap(lambda k: jax.random.permutation(k, VOLUME))(
            jax.random.split(k_perm, self.b))
        order = jax.random.permutation(k_order, self.offset_count)
        return _t(perm).long(), _t(order)

    def chunk(self, i, k):
        self.key, k_idx, k_mask, k_draw = jax.random.split(self.key, 4)
        _, k_pos = jax.random.split(k_idx)
        return psparse.ChunkDraws(
            positions=_t(jax.random.uniform(k_pos, (self.b, VOLUME))),
            mask=_t(jax.random.uniform(k_mask, (self.b, N_CTX))),
            gumbel=_t(jax.random.gumbel(k_draw, (self.b, N_CTX, self.k))))


@pytest.mark.parametrize("sampling_type", ["neighbors", "uniform"])
def test_sparse_denoise_volume_matches_jax_under_its_draws(sampling_type):
    """One deterministic logits function defined in numpy (a token table
    plus a position table: f32 additions, exact on both sides) drives both
    sweeps, so the token volumes must be equal."""
    b, iters = 2, 4
    rng = np.random.default_rng(7)
    tok_table = rng.normal(size=(K + 1, K)).astype(np.float32)
    pos_table = rng.normal(size=(VOLUME, K)).astype(np.float32)

    def jax_logits(toks, idx):
        return jnp.asarray(tok_table)[toks] + jnp.asarray(pos_table)[idx]

    def port_logits(toks, idx):
        return torch.from_numpy(tok_table)[toks] + torch.from_numpy(pos_table)[idx]

    key = jax.random.PRNGKey(8)
    kw = dict(batch_size=b, shape=SHAPE, num_classes=K, mask_token=K,
              num_context=N_CTX, num_iterations=iters, sampling_type=sampling_type)
    want = jsparse.sparse_denoise_volume(key, jax_logits, **kw)
    got = psparse.sparse_denoise_volume(
        port_logits, draws=JaxDraws(key, b, K, sampling_type), **kw)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # at this size the last sweep's windows need not cover the volume, so
    # a position may keep the mask token K
    assert got.shape == (b, *SHAPE) and int(got.max()) <= K
    # the default draws come from a generator: reproducible, in range
    runs = [psparse.sparse_denoise_volume(
        port_logits, generator=torch.Generator().manual_seed(1), **kw) for _ in range(2)]
    assert torch.equal(*runs) and int(runs[0].max()) <= K and int(runs[0].min()) >= 0
    with pytest.raises(ValueError, match="sampling_type"):
        psparse.sparse_denoise_volume(port_logits, **dict(kw, sampling_type="x"))


def test_buffered_sampler_gives_jax_clips_for_a_seed():
    kw = dict(buffer_size=60, max_segment_length=30, traj_len=4, skip_frames=1, seed=3)
    js = JaxSampler(JaxSource(num_trajectories=3, traj_frames=80, frame_size=16), **kw)
    ps = BufferedTrajectorySampler(
        SyntheticTrajectorySource(num_trajectories=3, traj_frames=80, frame_size=16), **kw)
    try:
        for _ in range(8):  # several buffers
            want = js.sample_batch(3)
            got = ps.sample_batch(3)
            assert got.shape == (3, 4, 16, 16, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    finally:
        js.close()
        ps.close()


# ------------------------------------------------------ the step, whole


def _jax_step_fn(jm, cfg):
    """The JAX trainer's step_body (cli/sparse_diffusion.py:400-501),
    composed from the package's public functions."""
    opt = jtrain.make_optimizer(
        cfg.optimizer, jtrain.warmup_cosine_schedule(cfg.lr, cfg.warmup, cfg.max_steps),
        cfg.weight_decay)

    @jax.jit
    def step(params, ema, opt_state, sampler, batch_z, key):
        b = batch_z.shape[0]
        k_r, k_idx, k_corrupt = jax.random.split(key, 3)
        if cfg.uniform_noise:
            r = jtrain.uniform_sample(k_r, b)
        else:
            r = jtrain.loss_aware_sample(sampler, k_r, b)
        if cfg.sampling_type == "uniform":
            indices = jsparse.sample_flat_positions(k_idx, b, cfg.num_context, VOLUME)
        else:
            indices = jsparse.sample_time_dependent(k_idx, b, cfg.num_context, SHAPE, r)
        target = jnp.take_along_axis(batch_z.reshape(b, -1), indices, axis=1)
        corrupted, _ = jmasked.corrupt_tokens(
            k_corrupt, target, r, num_classes=K, mask_token=K,
            p_max_uniform=cfg.p_max_uniform)

        def loss_fn(p):
            logits = jm.apply({"params": p}, corrupted, indices).astype(jnp.float32)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits.reshape(-1, K), target.reshape(-1))
            return ce.mean(), ce.reshape(b, -1).mean(axis=1)

        (loss, per_sample), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        gn = optax.global_norm(grads)
        old = (params, ema, opt_state, sampler)
        if not cfg.uniform_noise:
            sampler = jtrain.loss_aware_update(sampler, r, jnp.nan_to_num(per_sample))
        updates, opt_state = opt.update(
            jax.tree_util.tree_map(jnp.nan_to_num, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jtrain.ema_update(ema, params, cfg.ema_decay)
        ok = jnp.isfinite(loss) & jnp.isfinite(gn)
        new = (params, ema, opt_state, sampler)
        return jguard.reject_nonfinite(ok, old, new), (loss, gn, ok)

    return step


def _port_draws(key, b, cfg):
    """JAX's draws of one step, split from its key as step_body splits."""
    k_r, k_idx, k_corrupt = jax.random.split(key, 3)
    k_bucket, k_jitter = jax.random.split(k_r)
    k_o, k_pos = jax.random.split(k_idx)
    k_mask, k_bern, k_uni = jax.random.split(k_corrupt, 3)
    n = cfg.num_context
    if cfg.sampling_type == "uniform":
        positions = np.stack([_np(jax.random.uniform(k, (VOLUME,)))
                              for k in jax.random.split(k_idx, b)])
    else:
        positions = _np(jax.random.uniform(k_pos, (b, VOLUME)))
    return sd.StepDraws(
        gumbel=_t(jax.random.gumbel(k_bucket, (b, 100))),
        jitter=_t(jax.random.uniform(k_r if cfg.uniform_noise else k_jitter, (b,))),
        offset_uniform=_t(jax.random.uniform(k_o, (b,))),
        position_uniform=torch.from_numpy(positions),
        mask_uniform=_t(jax.random.uniform(k_mask, (b, n))),
        resample_uniform=_t(jax.random.uniform(k_bern, (b, n))),
        uniform_classes=_t(jax.random.randint(k_uni, (b, n), 0, K)),
    )


def _step_cfg(**kw):
    base = dict(platform="cpu", S=SHAPE[0], H=SHAPE[1], W=SHAPE[2],
                num_context=N_CTX, dim=MODEL["dim"], heads=MODEL["heads"],
                depth=MODEL["depth"], mlp_dim=MODEL["mlp_dim"], lr=1e-3,
                weight_decay=1e-2, warmup=2, max_steps=10, ema_decay=0.9,
                p_max_uniform=0.5, attn_backend="flash")
    base.update(kw)
    return sd.SparseDiffusionConfig(**base)


@pytest.mark.parametrize("sampling_type,uniform_noise",
                         [("neighbors", False), ("uniform", True)])
def test_three_f32_train_steps_match_the_jax_step(jax_model, sampling_type, uniform_noise):
    jm, params = jax_model
    cfg = _step_cfg(sampling_type=sampling_type, uniform_noise=uniform_noise)
    jstep = _jax_step_fn(jm, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt = jtrain.make_optimizer(cfg.optimizer, jtrain.warmup_cosine_schedule(
        cfg.lr, cfg.warmup, cfg.max_steps), cfg.weight_decay)
    jstate = (jp, jtrain.ema_init(jp), opt.init(jp), jtrain.loss_aware_init())
    model = sd.make_model(cfg, K, "cpu")
    model.load_state_dict(convert.sparse_state_dict_from_params(params), strict=True)
    state = sd.init_state(cfg, model)
    b = 4
    rng = np.random.default_rng(9)
    for i in range(3):
        batch = rng.integers(0, K, size=(b, *SHAPE)).astype(np.int32)
        key = jax.random.PRNGKey(200 + i)
        jstate, (loss, gn, ok) = jstep(*jstate, jnp.asarray(batch), key)
        got = sd.train_step(state, torch.from_numpy(batch).long(), cfg,
                            _port_draws(key, b, cfg))
        assert got[2] and bool(ok)
        assert abs(got[0] - float(loss)) <= TOL, (i, got[0], float(loss))
        assert abs(got[1] - float(gn)) <= TOL * max(1.0, float(gn)), (i, got[1], float(gn))
        want = convert.sparse_state_dict_from_params(jax.device_get(jstate[0]))
        want_ema = convert.sparse_state_dict_from_params(jax.device_get(jstate[1]))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=TOL, err_msg=name)
            np.testing.assert_allclose(state.ema[name].numpy(), want_ema[name].numpy(),
                                       rtol=0, atol=TOL, err_msg=f"ema {name}")
        # Adam's moments: mu to TOL; nu (squared gradients, ~1e-6) relative
        # to the largest of its tensor
        adam = jstate[2][0]
        for moment, torch_name in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            want_m = convert.sparse_state_dict_from_params(jax.device_get(moment))
            for name, p in model.named_parameters():
                w = want_m[name].numpy()
                atol = TOL if torch_name == "exp_avg" else TOL * float(np.abs(w).max())
                mu, nu = state.optimizer.moments(p)
                np.testing.assert_allclose(
                    (mu if torch_name == "exp_avg" else nu).numpy(), w,
                    rtol=0, atol=atol, err_msg=f"{torch_name} {name}")
        np.testing.assert_array_equal(state.sampler.counts.numpy(), _np(jstate[3].counts))
        np.testing.assert_allclose(state.sampler.weights.numpy(), _np(jstate[3].weights),
                                   rtol=SAMPLER_RTOL)
        assert state.step == state.optimizer.count == i + 1


# ------------------------------------------------- the trainer, end to end

IMG = 16
TOK_CFG = dict(embedding_dim=8, num_embeddings=K, downscale_steps=2,
               hidden_planes=8, in_channels=3)


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    torch.manual_seed(0)
    tok = VQAutoEncoder(**TOK_CFG, device="cpu")
    return ptrain.save_checkpoint(
        str(tmp_path_factory.mktemp("ptok")), 0, {"tokenizer": tok.state_dict()}, TOK_CFG)


def _tiny(tok_path, out, **kw):
    base = dict(
        platform="cpu", decoder_model=tok_path, output_dir=str(out),
        image_size=IMG, S=SHAPE[0], H=SHAPE[1], W=SHAPE[2], num_context=N_CTX,
        batch_size=2, eval_batch_size=2, dim=MODEL["dim"], heads=MODEL["heads"],
        depth=MODEL["depth"], mlp_dim=MODEL["mlp_dim"], warmup=2, max_steps=4,
        eval_interval=4, num_eval_iterations=2, checkpoint_interval=2,
        log_interval=2, ema_decay=0.9, bf16=True, buffer_size=60,
        change_batch_interval=2)
    base.update(kw)
    return sd.SparseDiffusionConfig(**base)


def _state_bits(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_train_evaluates_checkpoints_and_resumes(tok_path, tmp_path, capsys):
    result = sd.train(_tiny(tok_path, tmp_path))
    out = capsys.readouterr().out
    logged = [line for line in out.splitlines() if ": loss " in line]
    assert [line.split(":")[0] for line in logged] == ["1", "2", "4"]
    assert all(np.isfinite(h[1]) for h in result.history)
    assert result.state.step == 4 and result.rejected == 0
    assert [(e[0], e[1]) for e in result.evals] == [(4, "base"), (4, "ema")]
    for _, _, path, _ in result.evals:
        assert os.path.isfile(path)
    files = sorted(os.listdir(tmp_path))
    assert "step_0000002" in files and "step_0000004" in files
    assert "sparse_diffusion_metrics.jsonl" in files
    # resume: the whole state, exactly; then two more steps
    ckpt = os.path.join(str(tmp_path), "step_0000004")
    resumed = sd.train(_tiny(tok_path, tmp_path / "b", checkpoint=ckpt, eval_interval=0))
    assert resumed.history == [] and resumed.state.step == 4
    assert resumed.state.optimizer.count == 4
    want = _state_bits(result.state)
    for k, v in _state_bits(resumed.state).items():
        assert torch.equal(v, want[k]), k
    more = sd.train(_tiny(tok_path, tmp_path / "c", checkpoint=ckpt, max_steps=6,
                          eval_interval=0))
    assert [h[0] for h in more.history] == [5, 6]
    # weights-only warm start: a fresh optimizer, whose first update runs
    # at lr 0 and so leaves the loaded weights as they are
    warm = sd.train(_tiny(tok_path, tmp_path / "d", init_from=ckpt, max_steps=1,
                          eval_interval=0))
    assert warm.state.step == 1 and warm.state.optimizer.count == 1
    for k, v in _state_bits(warm.state).items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("uniform_noise", [False, True])
def test_train_logs_sampler_histograms_unless_uniform_noise(tok_path, tmp_path, uniform_noise):
    """C.9: the sampler weights' histogram every histogram_interval steps,
    as JAX writes it (cli/sparse_diffusion.py:775-783), and none under
    uniform_noise (no sampler)."""
    result = sd.train(_tiny(tok_path, tmp_path, histogram_interval=2, eval_interval=0,
                            uniform_noise=uniform_noise))
    with open(os.path.join(str(tmp_path), "sparse_diffusion_metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    assert [r["step"] for r in rec if "loss" in r] == [1, 2, 4]
    hists = [r for r in rec if "histogram" in r]
    if uniform_noise:
        assert hists == []
        return
    assert [(r["step"], r["histogram"]) for r in hists] == [(2, "sampler_weights"),
                                                            (4, "sampler_weights")]
    counts, edges = np.histogram(
        ptrain.loss_aware_weights(result.state.sampler).numpy(), bins=64)
    assert hists[-1]["counts"] == counts.tolist()
    assert hists[-1]["edges"] == np.round(edges, 6).tolist()


def test_single_batch_writes_gt_and_frames(tok_path, tmp_path):
    result = sd.train(_tiny(tok_path, tmp_path, single_batch=True, max_steps=2,
                            eval_interval=2, ema_decay=0.0, save_frames=True,
                            sampling_type="uniform", bf16=False))
    files = os.listdir(tmp_path)
    assert "gt.png" in files
    assert sum(f.startswith("sparse_diffusion_base_frame_") for f in files) == SHAPE[0]
    assert [e[1] for e in result.evals] == ["base"]


def test_decode_volume_clamps_the_mask_token(tok_path):
    tok, _ = sd.load_tokenizer(tok_path, "cpu")
    vol = torch.randint(0, K + 1, (2, *SHAPE), generator=torch.Generator().manual_seed(0))
    vol[0, 0, 0, 0] = K
    frames = sd.decode_volume(tok, vol, decode_n=3)
    assert frames.shape == (2, SHAPE[0], IMG, IMG, 3) and np.isfinite(frames).all()
    clamped = torch.where(vol >= K, 0, vol)
    np.testing.assert_array_equal(frames, sd.decode_volume(tok, clamped))


UNPORTED = [
    dict(dataset="minerl"), dict(n_model=2), dict(n_pipe=2), dict(fsdp=True),
    dict(n_micro=2),
]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: f"{next(iter(kw))}={next(iter(kw.values()))}")
def test_unported_options_raise(tok_path, tmp_path, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        sd.train(_tiny(tok_path, tmp_path, **kw))


def test_config_checks_and_platform(tok_path, tmp_path, monkeypatch):
    sd.check_supported(_tiny(tok_path, tmp_path, log_fence="sync"))
    with pytest.raises(ValueError, match="log_fence"):
        sd.train(_tiny(tok_path, tmp_path, log_fence="eager"))
    with pytest.raises(ValueError, match="sampling_type"):
        sd.train(_tiny(tok_path, tmp_path, sampling_type="random"))
    with pytest.raises(ValueError, match="token volumes"):
        sd.train(_tiny(tok_path, tmp_path, H=8, W=8))
    with pytest.raises(ValueError, match="platform"):
        sd.train(_tiny(tok_path, tmp_path, platform="tpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sd.train(_tiny(tok_path, tmp_path, platform=""))
    defaults = sd.SparseDiffusionConfig()
    assert dataclasses.asdict(defaults)["num_context"] == 512
    assert defaults.buffer_size == 75_000 and defaults.attn_backend == "auto"
