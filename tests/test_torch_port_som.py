"""Port parity: the self-organizing map (``ops.som``) and the SOM
autoencoder (``models.som_autoencoder``, carried across by
``convert.som_tokenizer_state_from_state``) against the JAX package on
seeded numpy inputs.

Tolerances: codecs exact; BMUs equal wherever the two nearest units of a
row differ by more than 1e-5 (f32 sums in another order flip near-ties);
the straight-through output, its difference and their gradients 1e-6;
``som_adapt`` (ragged tail, counts) embeddings 1e-5, counts exact, error
1e-6 relative; the autoencoder's reconstructions, latents and BatchNorm
statistics 1e-4 (f32 convolutions in another order), its 2-D codes equal
where the latent's top-2 gap exceeds 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.models.som_autoencoder import SomAutoEncoder as JaxSomAE  # noqa: E402
from world_modelz_tpu.ops import som as jsom  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.models.som_autoencoder import SomAutoEncoder  # noqa: E402
from world_modelz_tpu_torch.ops import som as psom  # noqa: E402

W, H, D = 8, 6, 5


def _np(x):
    return np.array(jax.device_get(x))


def _states(seed=0):
    js = jsom.som_init(jax.random.PRNGKey(seed), width=W, height=H, embedding_dim=D)
    js = js.replace(activation_count=jnp.arange(W * H, dtype=jnp.int32) % 3)
    ps = psom.SomState(torch.from_numpy(_np(js.embedding)),
                       torch.from_numpy(_np(js.activation_count)), W, H)
    return js, ps


def _x(seed, n=50):
    return (0.1 * np.random.default_rng(seed).normal(size=(n, D))).astype(np.float32)


def _gap_mask(emb, x, gap):
    d = ((x[:, None, :].astype(np.float64) - emb[None].astype(np.float64)) ** 2).sum(-1)
    s = np.sort(d, axis=1)
    return s[:, 1] - s[:, 0] > gap


def test_codecs_and_init_match_jax():
    js, ps = _states()
    idx = np.arange(W * H).reshape(H, W)
    want = _np(jsom.encode_indices_2d(js, jnp.asarray(idx)))
    got = psom.encode_indices_2d(ps, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    pos = np.random.default_rng(1).uniform(-1.3, 1.3, size=(40, 2)).astype(np.float32)
    pos[:4] = [[-1, -1], [1, 1], [0, 0], [0.25, -0.5]]
    np.testing.assert_array_equal(psom.decode_indices_2d(ps, torch.from_numpy(pos)).numpy(),
                                  _np(jsom.decode_indices_2d(js, jnp.asarray(pos))))
    # the codecs invert each other
    assert torch.equal(psom.decode_indices_2d(ps, got), torch.from_numpy(idx))
    np.testing.assert_array_equal(
        psom.som_decode_2d(ps, torch.from_numpy(pos)).numpy(),
        _np(jsom.som_decode_2d(js, jnp.asarray(pos))))
    # the map's init: uniform(-0.1, 0.1), zero counts
    init = psom.som_init(W, H, D, generator=torch.Generator().manual_seed(0))
    assert init.embedding.shape == (W * H, D) and float(init.embedding.abs().max()) <= 0.1
    assert init.activation_count.dtype == torch.int32 and not init.activation_count.any()
    assert not psom.som_reset_stats(ps).activation_count.any()


def test_encode_and_straight_through_match_jax():
    js, ps = _states(2)
    x = _x(3).reshape(5, 10, D)
    want = _np(jsom.som_encode(js, jnp.asarray(x)))
    got = psom.som_encode(ps, torch.from_numpy(x)).numpy()
    mask = _gap_mask(_np(js.embedding), x.reshape(-1, D), 1e-5).reshape(5, 10)
    assert mask.mean() > 0.9
    np.testing.assert_array_equal(got[mask], want[mask])
    np.testing.assert_array_equal(psom.som_encode_2d(ps, torch.from_numpy(x)).numpy()[mask],
                                  _np(jsom.som_encode_2d(js, jnp.asarray(x)))[mask])
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def loss(xx):
        st, diff = jsom.som_forward(js, xx)
        return jnp.sum(st * w) + 3.0 * diff

    (st, diff), gx = jsom.som_forward(js, jnp.asarray(x)), jax.grad(loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    pst, pdiff = psom.som_forward(ps, xt)
    ((pst * torch.from_numpy(w)).sum() + 3.0 * pdiff).backward()
    np.testing.assert_allclose(pst.detach().numpy(), _np(st), rtol=0, atol=1e-6)
    assert abs(float(pdiff.detach()) - float(diff)) <= 1e-6
    np.testing.assert_allclose(xt.grad.numpy(), _np(gx), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,chunk,stats", [(50, 16, True), (50, 64, True), (40, 8, False)])
def test_som_adapt_matches_jax_chunks_tail_and_counts(n, chunk, stats):
    js, ps = _states(5)
    x = _x(6, n)
    jnew, jerr = jsom.som_adapt(js, jnp.asarray(x), 0.3, 2.5, adapt_batch_size=chunk,
                                stats=stats)
    pnew, perr = psom.som_adapt(ps, torch.from_numpy(x), 0.3, 2.5, adapt_batch_size=chunk,
                                stats=stats)
    np.testing.assert_allclose(pnew.embedding.numpy(), _np(jnew.embedding), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pnew.activation_count.numpy(), _np(jnew.activation_count))
    assert abs(float(perr) - float(jerr)) <= 1e-6 * max(1.0, abs(float(jerr)))
    # the input state is left as it was
    np.testing.assert_array_equal(ps.embedding.numpy(), _np(js.embedding))
    # a negative rate and a zero radius are clamped, as JAX clamps them
    same, _ = psom.som_adapt(ps, torch.from_numpy(x), -1.0, 2.5, adapt_batch_size=chunk)
    assert torch.equal(same.embedding, ps.embedding)
    jz, _ = jsom.som_adapt(js, jnp.asarray(x), 0.3, 0.0, adapt_batch_size=chunk)
    pz, _ = psom.som_adapt(ps, torch.from_numpy(x), 0.3, 0.0, adapt_batch_size=chunk)
    np.testing.assert_allclose(pz.embedding.numpy(), _np(jz.embedding), rtol=0, atol=1e-5)


AE = dict(embedding_dim=8, downscale_steps=2, hidden_planes=8, in_channels=3)
IMG = 16


@pytest.fixture(scope="module")
def ae_pair():
    jae = JaxSomAE(**AE, som_width=W, som_height=H, pass_through_som=True)
    state = jax.jit(jae.init)(jax.random.PRNGKey(7), jnp.zeros((1, IMG, IMG, 3)))
    # non-trivial BatchNorm statistics, and a SOM fitted to the latents
    _, _, _, state = jax.jit(lambda st, x: jae.forward(st, x, train=True))(
        state, jax.random.uniform(jax.random.PRNGKey(8), (4, IMG, IMG, 3)))
    h = jae.encode_latent(state, jax.random.uniform(jax.random.PRNGKey(9), (4, IMG, IMG, 3)))
    som, _ = jsom.som_adapt(state.som, h, 0.5, 3.0, adapt_batch_size=16)
    state = jax.device_get(state.replace(som=som))
    pae = SomAutoEncoder(**AE, som_width=3, som_height=3, pass_through_som=True, device="cpu")
    pae.load_tokenizer_state(convert.som_tokenizer_state_from_state(
        state.params, state.batch_stats, state.som))
    return jae, state, pae


def _images(seed, b=3):
    return np.random.default_rng(seed).uniform(size=(b, IMG, IMG, 3)).astype(np.float32)


def test_som_autoencoder_matches_jax_eval(ae_pair):
    jae, state, pae = ae_pair
    assert (pae.som_width, pae.som_height) == (W, H)
    x = _images(10)
    h = _np(jae.encode_latent(state, jnp.asarray(x)))
    np.testing.assert_allclose(pae.encode_latent(torch.from_numpy(x)).detach().numpy(), h,
                               rtol=0, atol=1e-4)
    recon, h_in, h_diff, _ = jae.forward(state, jnp.asarray(x), train=False)
    with torch.no_grad():
        precon, ph_in, ph_diff = pae(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(ph_in.numpy(), _np(h_in), rtol=0, atol=1e-4)
    mask = _gap_mask(_np(state.som.embedding), h.reshape(-1, AE["embedding_dim"]), 1e-4)
    assert mask.all()  # the reconstruction goes through the same units
    np.testing.assert_allclose(precon.numpy(), _np(recon), rtol=0, atol=1e-4)
    assert abs(float(ph_diff) - float(h_diff)) <= 1e-4
    codes = _np(jae.encode_2d(state, jnp.asarray(x)))
    np.testing.assert_array_equal(pae.encode_2d(torch.from_numpy(x)).numpy(), codes)
    np.testing.assert_allclose(pae.decode_2d(torch.from_numpy(codes)).numpy(),
                               _np(jae.decode_2d(state, jnp.asarray(codes))), rtol=0, atol=1e-4)
    # without the SOM the forward gives no difference
    bypass = SomAutoEncoder(**AE, som_width=W, som_height=H, device="cpu")
    bypass.load_tokenizer_state(pae.tokenizer_state())
    assert bypass(torch.from_numpy(x))[2] is None


def test_som_autoencoder_train_forward_matches_jax(ae_pair):
    """The training forward: batch statistics, the running statistics'
    update, and the gradients of reconstruction + SOM losses."""
    jae, state, pae = ae_pair
    pae = SomAutoEncoder(**AE, som_width=W, som_height=H, pass_through_som=True, device="cpu")
    pae.load_tokenizer_state(convert.som_tokenizer_state_from_state(
        state.params, state.batch_stats, state.som))
    x = _images(11, b=4)

    def loss(params):
        recon, _, h_diff, new = jae.forward(state.replace(params=params), jnp.asarray(x),
                                            train=True)
        return jnp.mean(jnp.abs(recon - x)) + 0.25 * h_diff, new

    (want, new), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(state.params)
    recon, _, h_diff = pae(torch.from_numpy(x), train=True)
    got = torch.mean(torch.abs(recon - torch.from_numpy(x))) + 0.25 * h_diff
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    want_sd = convert.som_tokenizer_state_from_state(
        jax.device_get(new.params), jax.device_get(new.batch_stats), new.som).state_dict
    for k, v in pae.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=0, atol=1e-4,
                                       err_msg=k)
    gsd = convert.som_tokenizer_state_from_state(
        jax.device_get(grads), jax.device_get(state.batch_stats), state.som).state_dict
    for name, p in pae.named_parameters():
        g = gsd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(g).max())), err_msg=name)
    # resizing the SOM keeps the convs
    before = {k: v.clone() for k, v in pae.state_dict().items()}
    pae.resize_som(4, 5, generator=torch.Generator().manual_seed(1))
    assert pae.som.embedding.shape == (20, AE["embedding_dim"])
    assert all(torch.equal(v, before[k]) for k, v in pae.state_dict().items())
