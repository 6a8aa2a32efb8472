"""Port parity: the SOM-DDPM's denoisers (``models.unet``, carried across
by ``convert.unet_state_dict_from_params``) and the DDPM
(``diffusion.ddpm``) against the JAX package, on weights perturbed away
from their zero-initialized convs and on seeded numpy inputs.

The timestep embedding's frequencies are exp()s, where XLA's and PyTorch's
differ by at most one f32 ulp; at the embedding's stretch of 5000 a ulp of
the frequency is up to 2.4e-4 of the phase, so the embedding is held to
within 2 ulps of its frequencies (5e-4 absolute on sin/cos), and the
networks are held tightly on JAX's own embedding (fed through the port's
function) and loosely on their own: outputs 1e-4 x max(1, max |y|) on
JAX's embedding, 2e-2 x on their own; gradients 1e-4 x max(1, max |g|).
The sampler on JAX's draws (injected noise) and an eps function free of
exp: trace 1e-5; the trace's steps exactly ``jnp.linspace``'s."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.diffusion import ddpm as jddpm  # noqa: E402
from world_modelz_tpu.models import unet as junet  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.diffusion import ddpm as pddpm  # noqa: E402
from world_modelz_tpu_torch.models import unet as punet  # noqa: E402

UNET = dict(in_channels=2, out_channels=2, model_channels=32, num_res_blocks=1,
            channel_mult=(1, 2), attention_resolutions=(2,), num_heads=2,
            num_heads_upsample=1)
SIMPLE = dict(d_model=32, num_layers=2, d_pos=8, out_channels=2)


def _np(x):
    return np.array(jax.device_get(x), np.float32)


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=a.shape)).astype(np.float32), params)


def _inputs(seed, b=2, hw=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hw, hw, 2)).astype(np.float32),
            rng.uniform(size=(b, 1)).astype(np.float32))


def test_timestep_embedding_matches_jax():
    t = np.random.default_rng(0).uniform(size=(7, 1)).astype(np.float32)
    for dim, stretch in ((32, 5000.0), (128, 5000.0), (8, 1.0)):
        want = _np(junet.timestep_embedding(jnp.asarray(t), dim, stretch=stretch))
        got = punet.timestep_embedding(torch.from_numpy(t), dim, stretch=stretch).numpy()
        # two ulps of the largest frequency, as a phase
        tol = 2 * stretch * 2.0**-23 + 1e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        assert got.shape == (7, dim)


@pytest.fixture(scope="module")
def unet_pair():
    jm = junet.UNetDiffusionModel(**UNET)
    x, t = _inputs(1)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), x, t)["params"], 2)
    pm = punet.UNetDiffusionModel(**UNET, device="cpu")
    pm.load_state_dict(convert.unet_state_dict_from_params(params), strict=True)
    return jm, params, pm


def _on_jax_embedding(monkeypatch, dim, stretch=5000.0):
    def emb(t, d, stretch=stretch, max_period=1e4):
        return torch.from_numpy(_np(junet.timestep_embedding(
            jnp.asarray(t.detach().numpy()), d, stretch=stretch, max_period=max_period)))

    monkeypatch.setattr(punet, "timestep_embedding", emb)


def test_unet_forward_and_gradients_match_jax(unet_pair, monkeypatch):
    jm, params, pm = unet_pair
    x, t = _inputs(3)
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, x, t) * w)

    want = _np(jax.jit(jm.apply)({"params": params}, x, t))
    assert np.abs(want).max() > 1e-2  # the zero-initialized convs were moved
    got_own = pm(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
    np.testing.assert_allclose(got_own, want, rtol=0,
                               atol=2e-2 * max(1.0, float(np.abs(want).max())))
    _on_jax_embedding(monkeypatch, UNET["model_channels"])
    got = pm(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
    (got * torch.from_numpy(w)).sum().backward()
    grads = convert.unet_state_dict_from_params(jax.device_get(jax.jit(jax.grad(loss))(params)))
    for name, p in pm.named_parameters():
        g = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(g).max())), err_msg=name)


def test_unet_defaults_build_with_jax_names():
    """The JAX defaults (channel_mult (1, 2, 3, 4), three res blocks,
    attention at 2 and 4): every flax parameter has its port tensor, of its
    shape, on 16 x 16 latents."""
    jm = junet.UNetDiffusionModel(model_channels=32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 2)),
                            jnp.zeros((1, 1)))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = convert.unet_state_dict_from_params(zeros)
    pm = punet.UNetDiffusionModel(model_channels=32, device="cpu")
    got = pm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    out = pm(torch.zeros(1, 16, 16, 2), torch.zeros(1, 1))
    assert out.shape == (1, 16, 16, 2) and not out.any()  # the output conv starts at zero


def test_simple_diffusion_model_matches_jax(monkeypatch):
    jm = junet.SimpleDiffusionModel(**SIMPLE)
    x, t = _inputs(5, hw=6)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(1), x, t)["params"], 6)
    pm = punet.SimpleDiffusionModel(**SIMPLE, device="cpu")
    pm.load_state_dict(convert.unet_state_dict_from_params(params), strict=True)
    want = _np(jax.jit(jm.apply)({"params": params}, x, t))
    assert np.abs(want).max() > 1e-2
    # stretch 1: the embedding's ulps are small, the port's own embedding
    got = pm(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_ddpm_corrupt_and_alpha_bar_match_jax():
    x0 = np.random.default_rng(7).normal(size=(3, 4, 4, 2)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    t = np.array([0.0, 0.37, 1.0], np.float32)
    xt, eps = jddpm.ddpm_corrupt(key, jnp.asarray(x0), jnp.asarray(t))
    pxt, peps = pddpm.ddpm_corrupt(torch.from_numpy(x0), torch.from_numpy(t[:, None]),
                                   torch.from_numpy(_np(eps)))
    np.testing.assert_allclose(pxt.numpy(), _np(xt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pddpm.alpha_bar(torch.from_numpy(t)).numpy(),
                               _np(jddpm.alpha_bar(jnp.asarray(t))), rtol=0, atol=1e-7)
    _, drawn = pddpm.ddpm_corrupt(torch.from_numpy(x0), torch.from_numpy(t),
                                  generator=torch.Generator().manual_seed(0))
    assert drawn.shape == x0.shape


@pytest.mark.parametrize("timesteps,trace", [(10, 4), (11, 3), (1000, 20), (7, 1)])
def test_trace_indices_are_jnp_linspace(timesteps, trace):
    want = np.asarray(jnp.linspace(0, timesteps - 1, trace).astype(jnp.int32))
    np.testing.assert_array_equal(pddpm.trace_indices(timesteps, trace), want)


def test_ddpm_sample_matches_jax_on_its_draws():
    """The x0-reprojection loop over 11 steps (the 10% switch falls between
    steps 1 and 2) on JAX's normal draws, with an eps function free of exp:
    a fixed linear map of x and t."""
    shape, timesteps, trace = (2, 4, 4, 2), 11, 4
    key = jax.random.PRNGKey(9)
    m = np.random.default_rng(10).normal(size=(2, 2)).astype(np.float32) * 0.3

    def jeps(x, t):
        return x @ m + t.reshape(-1, 1, 1, 1)

    want = _np(jddpm.ddpm_sample(key, jeps, shape, timesteps=timesteps, trace_steps=trace))
    # JAX's draws: the scan splits its key once a step
    noise, k = [], key
    for _ in range(timesteps):
        k, k_eps = jax.random.split(k)
        noise.append(_np(jax.random.normal(k_eps, shape)))
    mt = torch.from_numpy(m)
    got = pddpm.ddpm_sample(lambda x, t: x @ mt + t.reshape(-1, 1, 1, 1), shape,
                            timesteps=timesteps, trace_steps=trace,
                            noise=torch.from_numpy(np.stack(noise)))
    assert got.shape == (trace, *shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert float(got.abs().max()) <= 1.25
    drawn = pddpm.ddpm_sample(lambda x, t: x @ mt, shape, timesteps=5, trace_steps=2,
                              generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, *shape) and bool(torch.isfinite(drawn).all())


def test_one_eps_loss_gradient_matches_jax(unet_pair, monkeypatch):
    """The DDPM training loss (MSE of the predicted eps on x_t) and its
    gradient, on JAX's draws and embedding."""
    jm, params, pm = unet_pair
    x0, t = _inputs(11)
    eps = np.random.default_rng(12).normal(size=x0.shape).astype(np.float32)
    a = _np(jddpm.alpha_bar(jnp.asarray(t)))[:, :, None, None]
    xt = (x0 * np.sqrt(a) + eps * np.sqrt(1 - a)).astype(np.float32)

    def loss(p):
        return jnp.mean((jm.apply({"params": p}, xt, t) - eps) ** 2)

    want, grads = jax.jit(jax.value_and_grad(loss))(params)
    _on_jax_embedding(monkeypatch, UNET["model_channels"])
    pm.zero_grad()
    pxt, _ = pddpm.ddpm_corrupt(torch.from_numpy(x0), torch.from_numpy(t),
                                torch.from_numpy(eps))
    np.testing.assert_allclose(pxt.numpy(), xt, rtol=0, atol=1e-6)
    got = torch.mean((pm(pxt, torch.from_numpy(t)) - torch.from_numpy(eps)) ** 2)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * max(1.0, float(want))
    grads = convert.unet_state_dict_from_params(jax.device_get(grads))
    for name, p in pm.named_parameters():
        g = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(g).max())), err_msg=name)
