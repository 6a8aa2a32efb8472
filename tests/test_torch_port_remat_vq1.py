"""Port parity: activation checkpointing of the local-3D attention
(``use_checkpointing``, JAX's ``models/attention.py:444, 492-493,
569-578``) and the single-codebook EMA quantizer (``ops.vq.vq1_init``,
``vq1_apply``; JAX's ``ops/vq.py:408, 419``).

Checkpointing recomputes the plain attention core in the backward pass:
the same operations on the same operands, so the gradients are bitwise
those without it. ``vq1_apply`` against the JAX function on the same state
and input: indices exact, everything else 1e-5 x max(1, max |x|) (f32 sums
in another order; with ``train`` the new codebook is ema_w over a
Laplace-smoothed size, which magnifies the rounding of rarely used codes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.ops import vq as jvq  # noqa: E402
from world_modelz_tpu_torch.models import VqVideoDiffusionModel  # noqa: E402
from world_modelz_tpu_torch.ops import vq as pvq  # noqa: E402

TOL = 1e-5


def _model(remat, backend="xla"):
    torch.manual_seed(0)
    return VqVideoDiffusionModel((3, 4, 4), 32, 16, (3, 1, 1), 2, 16, 24, heads=2,
                                 backend=backend, use_checkpointing=remat,
                                 device="cpu").train()


def _grads(remat, backend="xla"):
    m = _model(remat, backend)
    tokens = torch.randint(0, 17, (2, 3, 4, 4), generator=torch.Generator().manual_seed(1))
    out = m(tokens)
    out.float().square().mean().backward()
    return out.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}, m


@pytest.mark.parametrize("backend", ["xla", "auto"])
def test_checkpointing_leaves_the_gradients_bitwise(backend):
    out_on, g_on, m = _grads(True, backend)
    out_off, g_off, _ = _grads(False, backend)
    assert m.config["use_checkpointing"] is True
    assert all(attn.fn.use_checkpointing for attn, _ in m.transformer.layers)
    assert torch.equal(out_on, out_off)
    for n in g_on:
        assert torch.equal(g_on[n], g_off[n]), n


def test_checkpointing_recomputes_the_plain_core_only():
    """With grad on, the plain (``xla``) core runs once more in the
    backward pass; under no_grad (serving) it runs once."""
    from world_modelz_tpu_torch.models import attention

    calls = []
    real = attention.local3d_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    attention.local3d_attention = counted
    try:
        for remat, want in ((True, 4), (False, 2)):
            calls.clear()
            _grads(remat)
            assert len(calls) == want, (remat, len(calls))
        m = _model(True)
        calls.clear()
        with torch.no_grad():
            m(torch.zeros((1, 3, 4, 4), dtype=torch.long))
        assert len(calls) == 2
    finally:
        attention.local3d_attention = real


@pytest.mark.parametrize("train", [True, False])
def test_vq1_apply_matches_jax(train):
    state = jvq.vq1_init(jax.random.PRNGKey(0), num_embeddings=16, embedding_dim=8)
    x = np.random.default_rng(0).normal(size=(4, 5, 8)).astype(np.float32)
    jout, jstate = jvq.vq1_apply(state, jnp.asarray(x), train=train)
    pstate = pvq.VQ1State(*(torch.from_numpy(np.array(a)) for a in (
        state.codebook, state.ema_cluster_size, state.ema_w)))
    xt = torch.from_numpy(x).requires_grad_(True)
    pout, pnew = pvq.vq1_apply(pstate, xt, train=train)
    np.testing.assert_array_equal(pout.indices.numpy(), np.asarray(jout.indices))
    assert pout.indices.dtype == torch.int32 and pout.indices.shape == (20,)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(want).max())))

    close(pout.quantized.detach().numpy(), jout.quantized)
    close(float(pout.commitment_loss.detach()), jout.commitment_loss)
    close(float(pout.perplexity), jout.perplexity)
    for name in ("codebook", "ema_cluster_size", "ema_w"):
        close(getattr(pnew, name).numpy(), getattr(jstate, name))
    # gradients reach x through the straight-through output and the loss
    (pout.quantized.sum() + pout.commitment_loss).backward()
    assert xt.grad is not None and bool(torch.isfinite(xt.grad).all())


def test_vq1_init_shapes():
    st = pvq.vq1_init(num_embeddings=16, embedding_dim=8,
                      generator=torch.Generator().manual_seed(0))
    assert st.codebook.shape == st.ema_w.shape == (16, 8)
    assert torch.equal(st.ema_cluster_size, torch.zeros(16))
    assert not torch.equal(st.codebook, st.ema_w)
