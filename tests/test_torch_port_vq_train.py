"""Port parity: the training half of the vector quantizer
(``world_modelz_tpu_torch.ops.vq`` and the ``vq_train_stats`` wrapper)
against the JAX package on the same numpy-seeded inputs.

Tolerances: indices and counts exact; quantized rows 1e-6 (an exact
gather on both sides); the per-code error and input sums rtol 1e-5 / atol
1e-5 (f32 sums in another order: the Pallas kernel's one-hot products vs
``index_add_``); the new VQ state, commitment loss, perplexity and the
commitment loss's gradient 1e-5 (the same f32 arithmetic in another
order); dead-code revival and the statistics reset exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.kernels.vq_kernels import vq_train_stats_pallas  # noqa: E402
from world_modelz_tpu.ops import vq as jvq  # noqa: E402
from world_modelz_tpu_torch.kernels import vq_train_stats  # noqa: E402
from world_modelz_tpu_torch.ops import vq as pvq  # noqa: E402

TOL = 1e-5


def _np(x):
    return np.array(jax.device_get(x))


def _state(rng, L, K, D, *, stats=True):
    """The same VQ state for JAX and the port (non-trivial EMA sizes and
    statistics)."""
    arrays = dict(
        codebook=rng.normal(size=(L, K, D)).astype(np.float32),
        cluster_size=rng.uniform(0.5, 2.0, size=(L, K)).astype(np.float32),
        activation_count=(rng.integers(0, 5, size=(L, K)) if stats
                          else np.zeros((L, K))).astype(np.float32),
        accumulated_error=(rng.uniform(size=(L, K)) if stats
                           else np.zeros((L, K))).astype(np.float32),
    )
    return (jvq.VQState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            pvq.VQState(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _assert_state(jstate, pstate, tol=TOL):
    for name in ("codebook", "cluster_size", "activation_count",
                 "accumulated_error"):
        np.testing.assert_allclose(
            getattr(pstate, name).numpy(), _np(getattr(jstate, name)),
            rtol=tol, atol=tol, err_msg=name)


# ----------------------------------------------- the fused statistics


@pytest.mark.parametrize("n", [64, 75], ids=["tiled", "ragged"])
def test_train_stats_plain_matches_pallas_interpret(n):
    """The plain version of the kernel against the Pallas kernel in
    interpret mode, a ragged N (padded rows masked out) included."""
    rng = np.random.default_rng(0)
    K, D = 24, 16
    x = rng.normal(size=(n, D)).astype(np.float32)
    cb = rng.normal(size=(K, D)).astype(np.float32)
    want = vq_train_stats_pallas(jnp.asarray(x), jnp.asarray(cb), tile_n=32,
                                 interpret=True)
    got = vq_train_stats(torch.from_numpy(x), torch.from_numpy(cb))
    idx, q, cnt, err, dw = (t.numpy() for t in got)
    w_idx, w_q, w_cnt, w_err, w_dw = (_np(t) for t in want)
    assert idx.dtype == np.int32 and q.shape == (n, D) and dw.shape == (K, D)
    np.testing.assert_array_equal(idx, w_idx)
    np.testing.assert_array_equal(cnt, w_cnt)
    assert cnt.sum() == n
    np.testing.assert_allclose(q, w_q, atol=1e-6, rtol=0)
    np.testing.assert_allclose(err, w_err, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw, w_dw, rtol=1e-5, atol=1e-5)


def test_train_stats_ties_go_to_the_lowest_code():
    """Duplicate codes tie exactly: argmin keeps the lower index, as the
    kernel's strict comparison does."""
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    x = torch.tensor([[2.0, 0.0], [0.0, 3.0], [0.5, 0.5]])
    idx, q, cnt, err, dw = vq_train_stats(x, cb)
    assert idx.tolist() == [0, 1, 0]
    assert cnt.tolist() == [2.0, 1.0, 0.0]
    torch.testing.assert_close(q, cb[idx.long()], rtol=0, atol=0)
    torch.testing.assert_close(err, torch.tensor([1.5, 4.0, 0.0]))
    torch.testing.assert_close(dw, torch.tensor([[2.5, 0.5], [0.0, 3.0], [0.0, 0.0]]))


def test_train_stats_wrapper_checks_its_inputs():
    with pytest.raises(ValueError, match=r"x \(N, D\)"):
        vq_train_stats(torch.zeros(4, 3), torch.zeros(5, 2))
    with pytest.raises(ValueError, match="CUDA device"):
        vq_train_stats(torch.zeros(4, 2, device="meta"), torch.zeros(5, 2))


# ----------------------------------------------------- vq_apply (xla)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("L", [1, 2])
def test_vq_apply_matches_jax(train, L):
    rng = np.random.default_rng(1)
    K, D = 16, 8
    jstate, pstate = _state(rng, L, K, D)
    x = rng.normal(size=(3, 4, 4, L * D)).astype(np.float32)
    jout, jnew = jvq.vq_apply(jstate, jnp.asarray(x), train=train)
    xt = torch.from_numpy(x).requires_grad_(True)
    pout, pnew = pvq.vq_apply(pstate, xt, train=train)
    np.testing.assert_array_equal(pout.indices.numpy(), _np(jout.indices))
    np.testing.assert_allclose(pout.quantized.detach().numpy(), _np(jout.quantized),
                               atol=TOL)
    np.testing.assert_allclose(pout.commitment_loss.item(),
                               float(jout.commitment_loss), rtol=TOL)
    np.testing.assert_allclose(float(pout.perplexity), float(jout.perplexity),
                               rtol=TOL)
    _assert_state(jnew, pnew)
    # the state is computed without a graph; x gets the commitment gradient
    assert not any(t.requires_grad for t in pnew.__dict__.values())
    want = jax.grad(
        lambda v: jvq.vq_apply(jstate, v, train=train)[0].commitment_loss)(
            jnp.asarray(x))
    (got,) = torch.autograd.grad(pout.commitment_loss, xt)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)
    # the straight-through output passes gradients to x unchanged
    (st,) = torch.autograd.grad(pout.quantized.sum(), xt)
    np.testing.assert_array_equal(st.numpy(), np.ones_like(x))


# ------------------------------------------------ vq_apply_fused (pallas)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_vq_apply_fused_matches_jax(train):
    rng = np.random.default_rng(2)
    K, D = 16, 8
    jstate, pstate = _state(rng, 1, K, D)
    x = rng.normal(size=(2, 5, 5, D)).astype(np.float32)  # N = 50, ragged
    jout, jnew = jvq.vq_apply_fused(jstate, jnp.asarray(x), train=train,
                                    interpret=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    pout, pnew = pvq.vq_apply_fused(pstate, xt, train=train)
    np.testing.assert_array_equal(pout.indices.numpy(), _np(jout.indices))
    assert tuple(pout.indices.shape) == (50, 1)
    np.testing.assert_allclose(pout.quantized.detach().numpy(), _np(jout.quantized),
                               atol=TOL)
    np.testing.assert_allclose(pout.commitment_loss.item(),
                               float(jout.commitment_loss), rtol=TOL)
    np.testing.assert_allclose(float(pout.perplexity), float(jout.perplexity),
                               rtol=TOL)
    _assert_state(jnew, pnew)
    want = jax.grad(lambda v: jvq.vq_apply_fused(
        jstate, v, train=train, interpret=True)[0].commitment_loss)(jnp.asarray(x))
    (got,) = torch.autograd.grad(pout.commitment_loss, xt)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)


def test_vq_apply_fused_takes_a_single_latent():
    _, pstate = _state(np.random.default_rng(3), 2, 8, 4)
    with pytest.raises(NotImplementedError, match="vq_apply"):
        pvq.vq_apply_fused(pstate, torch.zeros(5, 8), train=True)


def test_fused_and_plain_share_the_codebook_update():
    """Only the per-code error differs between the two (the kernel's
    max(min dist + |x|^2, 0) vs the direct squared difference)."""
    rng = np.random.default_rng(4)
    _, pstate = _state(rng, 1, 16, 8)
    x = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    a, new_a = pvq.vq_apply(pstate, x, train=True)
    b, new_b = pvq.vq_apply_fused(pstate, x, train=True)
    assert torch.equal(a.indices, b.indices)
    for name in ("codebook", "cluster_size", "activation_count"):
        torch.testing.assert_close(getattr(new_a, name), getattr(new_b, name),
                                   rtol=TOL, atol=TOL)
    torch.testing.assert_close(new_a.accumulated_error, new_b.accumulated_error,
                               rtol=1e-4, atol=1e-4)


# --------------------------------------- revival, reset, masked decode


def test_vq_reuse_inactive_matches_jax_with_tied_counts():
    """Dead codes take the i-th most active code; ties among the active
    counts keep index order (a stable sort), as JAX's argsort."""
    rng = np.random.default_rng(5)
    L, K, D = 2, 12, 4
    jstate, pstate = _state(rng, L, K, D)
    counts = np.array([[0, 3, 3, 0, 1, 3, 0, 1, 0, 2, 2, 0],
                       [5, 0, 5, 5, 0, 0, 1, 1, 0, 0, 0, 2]], np.float32)
    jstate = jstate.replace(activation_count=jnp.asarray(counts))
    pstate = pstate.replace(activation_count=torch.from_numpy(counts))
    jnew, jcount = jvq.vq_reuse_inactive(jstate)
    pnew, pcount = pvq.vq_reuse_inactive(pstate)
    assert int(pcount) == int(jcount) == int((counts == 0).sum())
    np.testing.assert_array_equal(pnew.codebook.numpy(), _np(jnew.codebook))
    # the first dead code of latent 0 (index 0) took the first of the
    # three most active (index 1), the second (index 3) the next (index 2)
    cb = pstate.codebook.numpy()
    np.testing.assert_array_equal(pnew.codebook.numpy()[0, 3],
                                  (cb[0, 3] * np.float32(0.1) + cb[0, 2] * np.float32(0.9)))
    jreset, preset = jvq.vq_reset_stats(jnew), pvq.vq_reset_stats(pnew)
    _assert_state(jreset, preset, tol=0)
    assert not preset.activation_count.any() and not preset.accumulated_error.any()


def test_vq_decode_masked_matches_jax():
    rng = np.random.default_rng(6)
    jstate, pstate = _state(rng, 1, 8, 4)
    idx = rng.integers(0, 9, size=(3, 5)).astype(np.int32)  # 8 = mask token
    want = jvq.vq_decode_masked(jstate, jnp.asarray(idx[..., None]), 8)
    got = pvq.vq_decode_masked(pstate.codebook, torch.from_numpy(idx[..., None]), 8)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert not got.numpy()[idx == 8].any()


def test_vq_init_layout():
    s = pvq.vq_init(2, 16, 8, generator=torch.Generator().manual_seed(0))
    assert tuple(s.codebook.shape) == (2, 16, 8)
    assert torch.equal(s.cluster_size, torch.ones(2, 16))
    assert not s.activation_count.any() and not s.accumulated_error.any()
