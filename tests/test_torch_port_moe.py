"""Port parity: the mixture-of-experts FFN (``parallel.moe``,
``models.attention.MoEFeedForward``, the sparse model's ``moe_*`` fields,
``convert.sparse_state_dict_from_params`` and ``cli.sparse_diffusion
--moe_experts``) against the JAX package on seeded numpy inputs.

Tolerances: f32 outputs 1e-5 x max(1, max |y|), the load-balance loss 1e-6
(f32 sums in another order); the index form equal to the port's einsum form
bitwise in f32 (a one-hot product adds only zeros); bf16: the routing must
agree on >= 99% of the tokens with JAX's and the outputs of the tokens
routed alike within 2^-7 x max |y| (bf16 rounding of the gate product may
flip a near-tied argmax); gradients 1e-5 x max(1, max |g|); a sparse model's
logits 1e-5 and gradients as above; one train step against JAX's loss_fn
with the sown ``moe_aux`` (loss 1e-5, gradients as above)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.models.attention import MoEFeedForward as JaxMoE  # noqa: E402
from world_modelz_tpu.models.video import VqSparseDiffusionModel as JaxSparse  # noqa: E402
from world_modelz_tpu.parallel import moe as jmoe  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.models import VQAutoEncoder, VqSparseDiffusionModel  # noqa: E402
from world_modelz_tpu_torch.models.attention import MoEFeedForward  # noqa: E402
from world_modelz_tpu_torch.parallel import moe as pmoe  # noqa: E402

TOL = 1e-5
B, N, D, HID, E = 2, 24, 16, 12, 4


def _np(x):
    return np.array(jax.device_get(x), np.float32)


def _params(seed=1):
    """JAX's init, perturbed so the biases are not zero."""
    p = jmoe.moe_init(jax.random.PRNGKey(seed), D, HID, E)
    keys = jax.random.split(jax.random.PRNGKey(seed + 10), 5)
    return jmoe.MoEParams(*[w + 0.1 * jax.random.normal(k, w.shape) for k, w in zip(keys, p)])


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=(B, N, D)).astype(np.float32)


def _port(p, dtype=torch.float32):
    return pmoe.MoEParams(*[torch.from_numpy(_np(w)).to(dtype) for w in p])


@pytest.mark.parametrize("capacity", [3, 6, N])
def test_moe_ffn_f32_matches_jax_with_drops_and_aux(capacity):
    p, x = _params(), _x()
    y, aux = jmoe.moe_ffn(p, jnp.asarray(x), capacity=capacity)
    y, aux = _np(y), float(aux)
    pp, xt = _port(p), torch.from_numpy(x)
    dense, dense_aux = pmoe.moe_ffn(pp, xt, capacity=capacity)
    idx, idx_aux = pmoe.moe_ffn_indexed(pp, xt, capacity=capacity)
    tol = TOL * max(1.0, float(np.abs(y).max()))
    np.testing.assert_allclose(dense.numpy(), y, rtol=0, atol=tol)
    assert torch.equal(idx, dense)
    assert abs(float(dense_aux) - aux) <= 1e-6 and float(idx_aux) == float(dense_aux)
    if capacity < N:  # some tokens were dropped: their rows are zero
        gate, expert = pmoe.route(pp, xt)
        assert int((pmoe._slots(gate, expert) >= capacity).sum()) > 0
    ref = pmoe.moe_reference(pp, xt)
    np.testing.assert_allclose(ref.numpy(), _np(jmoe.moe_reference(p, jnp.asarray(x))),
                               rtol=0, atol=tol)
    if capacity == N:  # lossless: the dispatch equals the per-token path
        np.testing.assert_allclose(dense.numpy(), ref.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("capacity", [4, N])
def test_moe_ffn_bf16_matches_jax_routing_agreement(capacity):
    p, x = _params(2), _x(3)
    pj = jax.tree_util.tree_map(lambda w: w.astype(jnp.bfloat16), p)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    y, aux = jmoe.moe_ffn(pj, xj, capacity=capacity)
    jgate = jax.nn.softmax((xj @ pj.w_gate).astype(jnp.float32), -1)
    jexpert = np.asarray(jnp.argmax(jgate, -1))
    pp, xt = _port(p, torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    got, got_aux = pmoe.moe_ffn_indexed(pp, xt, capacity=capacity)
    dense, _ = pmoe.moe_ffn(pp, xt, capacity=capacity)
    assert got.dtype == torch.bfloat16 and torch.equal(got, dense)
    _, expert = pmoe.route(pp, xt)
    same = expert.numpy() == jexpert
    assert same.mean() >= 0.99, same.mean()
    y = _np(y.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy()[same], y[same], rtol=0,
                               atol=2**-7 * float(np.abs(y).max()))
    assert abs(float(got_aux) - float(aux)) <= 1e-2 * float(aux)


@pytest.mark.parametrize("impl", ["dispatch", "einsum", "reference"])
def test_moe_feedforward_gradients_match_jax(impl, monkeypatch):
    """MoEFeedForward's output, aux and the gradients of both (every
    parameter and the input) against jax.grad of JAX's module; "einsum"
    runs the module's main path through the plain einsum form instead."""
    if impl == "einsum":
        monkeypatch.setattr(pmoe, "moe_ffn_indexed", pmoe.moe_ffn)
    x = _x(4)
    jm = JaxMoE(hidden_dim=HID, num_experts=E, capacity_factor=1.0,
                impl="reference" if impl == "reference" else "dispatch")
    params = jax.jit(jm.init)(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    keys = jax.random.split(jax.random.PRNGKey(6), 5)
    params = {k: params[k] + 0.1 * jax.random.normal(kk, params[k].shape)
              for k, kk in zip(sorted(params), keys)}
    w = np.random.default_rng(7).normal(size=(B, N, D)).astype(np.float32)

    def loss(p, xx):
        y, aux = jm.apply({"params": p}, xx, mutable=["losses"])
        return jnp.sum(y * w) + 3.0 * aux["losses"]["moe_aux"][0]

    want = float(jax.jit(loss)(params, jnp.asarray(x)))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    m = MoEFeedForward(D, HID, E, capacity_factor=1.0,
                       impl="reference" if impl == "reference" else "dispatch")
    with torch.no_grad():
        for k in params:
            getattr(m, k).copy_(torch.from_numpy(_np(params[k])))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = m(xt)
    got = (y * torch.from_numpy(w)).sum() + 3.0 * aux
    got.backward()
    assert abs(float(got.detach()) - want) <= TOL * max(1.0, abs(want))
    for name, g in list(gp.items()) + [("x", gx)]:
        g = _np(g)
        t = xt.grad if name == "x" else getattr(m, name).grad
        np.testing.assert_allclose(t.numpy(), g, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(g).max())), err_msg=name)


SHAPE, K, N_CTX = (4, 4, 4), 16, 24
MODEL = dict(dim=32, num_classes=K, depth=2, dim_head=16, mlp_dim=24, heads=2)


@pytest.fixture(scope="module")
def jax_moe_model():
    jm = JaxSparse(shape=SHAPE, attn_backend="xla", moe_experts=2, moe_capacity_factor=1.0,
                   **MODEL)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, N_CTX), jnp.int32),
        jnp.zeros((1, N_CTX), jnp.int32))["params"])
    # non-zero expert biases
    for i in range(MODEL["depth"]):
        ff = params["transformer"][f"MoEFeedForward_{i}"]
        for k in ("b_in", "b_out"):
            ff[k] = np.random.default_rng(i).normal(size=ff[k].shape).astype(np.float32) * 0.1
    return jm, params


def _tokens(seed, b=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, K + 1, size=(b, N_CTX)).astype(np.int32)
    indices = np.stack([rng.permutation(64)[:N_CTX] for _ in range(b)]).astype(np.int32)
    return tokens, indices


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_sparse_moe_model_matches_jax_apply(jax_moe_model, backend):
    jm, params = jax_moe_model
    tokens, indices = _tokens(1)
    w = np.random.default_rng(2).normal(size=(3, N_CTX, K)).astype(np.float32)

    def loss(p):
        logits, aux = jm.apply({"params": p}, tokens, indices, mutable=["losses"])
        leaves = jax.tree_util.tree_leaves(aux["losses"])
        return jnp.sum(logits * w) + 0.5 * sum(jnp.mean(a) for a in leaves) / len(leaves)

    logits, aux = jax.jit(lambda p: jm.apply({"params": p}, tokens, indices,
                                             mutable=["losses"]))(params)
    leaves = jax.tree_util.tree_leaves(aux["losses"])
    want_aux = float(sum(jnp.mean(a) for a in leaves) / len(leaves))
    grads = convert.sparse_state_dict_from_params(jax.device_get(jax.jit(jax.grad(loss))(params)))
    model = VqSparseDiffusionModel(SHAPE, attn_backend=backend, moe_experts=2,
                                   moe_capacity_factor=1.0, device="cpu", **MODEL)
    model.load_state_dict(convert.sparse_state_dict_from_params(params), strict=True)
    got, got_aux = model(torch.from_numpy(tokens), torch.from_numpy(indices), return_aux=True)
    np.testing.assert_allclose(got.detach().numpy(), _np(logits), rtol=0, atol=TOL)
    assert abs(float(got_aux.detach()) - want_aux) <= 1e-6
    ((got * torch.from_numpy(w)).sum() + 0.5 * got_aux).backward()
    for name, p in model.named_parameters():
        g = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(g).max())), err_msg=name)
    # without return_aux the model gives the logits alone (the sweep's call)
    assert torch.equal(model(torch.from_numpy(tokens), torch.from_numpy(indices)), got)


def test_moe_train_step_adds_the_weighted_aux_like_jax(jax_moe_model, monkeypatch):
    """One f32 step of the port's trainer: its loss and gradients against
    JAX's loss_fn (CE + moe_aux_weight x the mean sown aux) on the step's
    own corrupted tokens and positions."""
    jm, params = jax_moe_model
    cfg = sd.SparseDiffusionConfig(
        platform="cpu", S=SHAPE[0], H=SHAPE[1], W=SHAPE[2], num_context=N_CTX,
        dim=MODEL["dim"], heads=MODEL["heads"], depth=MODEL["depth"],
        mlp_dim=MODEL["mlp_dim"], lr=1e-3, warmup=2, max_steps=10, ema_decay=0.0,
        moe_experts=2, moe_capacity_factor=1.0, moe_aux_weight=0.5,
        sampling_type="uniform", uniform_noise=True)
    model = sd.make_model(cfg, K, "cpu")
    model.load_state_dict(convert.sparse_state_dict_from_params(params), strict=True)
    state = sd.init_state(cfg, model)
    seen = {}
    ce_step = sd.ce_step

    def spy(st, inputs, target, r, c):
        seen.update(inputs=[t.clone() for t in inputs], target=target.clone())
        return ce_step(st, inputs, target, r, c)

    monkeypatch.setattr(sd, "ce_step", spy)
    b = 2
    batch = torch.from_numpy(np.random.default_rng(3).integers(0, K, size=(b, *SHAPE)))
    draws = sd.draw_step(torch.Generator().manual_seed(4), b, N_CTX, 64, 100, K)
    loss, _, ok = sd.train_step(state, batch, cfg, draws)
    corrupted, indices = (t.numpy() for t in seen["inputs"])
    target = seen["target"].numpy()

    def loss_fn(p):
        logits, aux = jm.apply({"params": p}, corrupted, indices, mutable=["losses"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.reshape(-1, K), target.reshape(-1)).mean()
        leaves = jax.tree_util.tree_leaves(aux["losses"])
        return ce + cfg.moe_aux_weight * sum(jnp.mean(a) for a in leaves) / len(leaves)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    assert ok and abs(loss - float(want)) <= TOL
    grads = convert.sparse_state_dict_from_params(jax.device_get(grads))
    for name, p in model.named_parameters():
        g = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(g).max())), err_msg=name)


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    torch.manual_seed(0)
    cfg = dict(embedding_dim=8, num_embeddings=K, downscale_steps=2, hidden_planes=8,
               in_channels=3)
    tok = VQAutoEncoder(**cfg, device="cpu")
    return ptrain.save_checkpoint(
        str(tmp_path_factory.mktemp("ptok")), 0, {"tokenizer": tok.state_dict()}, cfg)


@pytest.mark.parametrize("k", [1, 2])
def test_sparse_cli_trains_moe_at_k(tok_path, tmp_path, k):
    """Three steps with --moe_experts 2 (JAX's tests/test_cli_smoke.py:277
    at the port's tiny width) at steps_per_dispatch k: finite losses, a
    checkpoint whose weights hold the experts, and k = 2 equal to k = 1."""
    def run(kk, out):
        return sd.train(sd.SparseDiffusionConfig(
            platform="cpu", decoder_model=tok_path, output_dir=str(out), image_size=16,
            S=SHAPE[0], H=SHAPE[1], W=SHAPE[2], num_context=N_CTX, batch_size=2,
            eval_batch_size=1, dim=16, mlp_dim=16, heads=2, depth=1, max_steps=3, warmup=2,
            moe_experts=2, moe_capacity_factor=2.0, eval_interval=3,
            num_eval_iterations=2, checkpoint_interval=3, buffer_size=60, log_interval=1,
            change_batch_interval=4, steps_per_dispatch=kk, name="sdm"))

    result = run(k, tmp_path)
    assert [h[0] for h in result.history] == [1, 2, 3]
    assert all(np.isfinite(h[1]) and h[3] for h in result.history)
    ckpt = os.path.join(str(tmp_path), "step_0000003")
    state, _, config = ptrain.restore_checkpoint(ckpt)
    assert config["moe_experts"] == 2
    assert state["params"]["transformer.layers.0.1.fn.w_in"].shape == (2, 16, 16)
    assert [e[1] for e in result.evals] == ["base"]
    if k == 2:
        one = run(1, tmp_path / "k1")
        assert [h[1] for h in one.history] == [h[1] for h in result.history]


def test_moe_refuses_pipeline_stages(tok_path, tmp_path):
    cfg = sd.SparseDiffusionConfig(platform="cpu", decoder_model=tok_path,
                                   output_dir=str(tmp_path), moe_experts=2, n_pipe=2)
    with pytest.raises(ValueError, match="--n_pipe"):
        sd.train(cfg)
