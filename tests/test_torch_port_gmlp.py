"""Port parity: the gMLP (``models.gmlp``) and the named noise schedules
(``diffusion.schedules``) against the JAX package.

The JAX ``GMLP`` is initialised from a seed and its params go into the
port through ``convert.gmlp_state_dict_from_params``; the forward and the
gradients of every parameter (taken through the same converter, which
transposes kernels) must agree within 1e-5 x max(1, max |x|) in float32
(f32 sums in another order; flax's LayerNorm takes the variance as
E[x^2] - E[x]^2, torch's two-pass). The schedules agree within 1e-6 (f32
cos in two libraries) and ``cos05`` stays finite at r = 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.diffusion.schedules import named_schedule as jax_schedule  # noqa: E402
from world_modelz_tpu.models.gmlp import GMLP as JaxGMLP  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.diffusion.schedules import named_schedule  # noqa: E402
from world_modelz_tpu_torch.models.gmlp import GMLP  # noqa: E402

TOL = 1e-5
SCHEDULES = ["linear", "cos1", "cos2", "cos05", "cos3", "cos2_inv", "cos3_inv"]
DIM, DEPTH, SEQ, K, VQ_D = 32, 2, 16, 10, 12


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("variant", ["plain", "attn", "causal"])
def test_gmlp_forward_and_gradients_match_jax(variant):
    attn_dim = None if variant == "plain" else 8
    causal = variant == "causal"
    jm = JaxGMLP(num_tokens_in=K + 1, num_tokens_out=K, dim=DIM, depth=DEPTH,
                 seq_len=SEQ, vq_embedding_dim=VQ_D, attn_dim=attn_dim, causal=causal)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, K + 1, (2, SEQ)).astype(np.int32)
    emb = rng.standard_normal((2, SEQ, VQ_D)).astype(np.float32)
    w = rng.standard_normal((2, SEQ, K)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(7), jnp.asarray(tokens), jnp.asarray(emb))["params"]
    # move the gate weights off their near-zero init so the token mix counts
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: p + 0.05 if "proj_weight" in jax.tree_util.keystr(path) else p,
        params)

    @jax.jit
    def loss_and_grads(p):
        def f(p):
            logits = jm.apply({"params": p}, tokens, emb)
            return jnp.sum(logits * w), logits
        (loss, logits), g = jax.value_and_grad(f, has_aux=True)(p)
        return logits, g

    jlogits, jgrads = loss_and_grads(params)
    pm = GMLP(K + 1, K, DIM, DEPTH, SEQ, vq_embedding_dim=VQ_D, attn_dim=attn_dim,
              causal=causal, device="cpu")
    sd = convert.gmlp_state_dict_from_params(jax.device_get(params))
    pm.load_state_dict(sd, strict=True)
    logits = pm(torch.from_numpy(tokens), torch.from_numpy(emb))
    _close(logits.detach().numpy(), jlogits)
    (logits * torch.from_numpy(w)).sum().backward()
    want = convert.gmlp_state_dict_from_params(jax.device_get(jgrads))
    names = dict(pm.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        _close(p.grad.numpy(), want[name].numpy())


def test_gmlp_layer_drop_is_identity_at_full_survival():
    pm = GMLP(K + 1, K, DIM, 2, SEQ, device="cpu")
    tokens = torch.randint(0, K + 1, (2, SEQ))
    torch.testing.assert_close(pm(tokens, train=True), pm(tokens), rtol=0, atol=0)
    pm.prob_survival = 0.5
    gen = torch.Generator().manual_seed(0)
    out = pm(tokens, train=True, generator=gen)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("name", SCHEDULES)
def test_named_schedules_match_jax(name):
    r = np.concatenate([np.linspace(0.0, 1.0, 101), [0.999999]]).astype(np.float32)
    want = np.asarray(jax_schedule(name)(jnp.asarray(r)))
    got = named_schedule(name)(torch.from_numpy(r)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cos05_at_one_is_finite_and_unknown_names_raise():
    one = torch.ones(3)
    assert torch.isfinite(named_schedule("cos05")(one)).all()
    with pytest.raises(ValueError, match="unknown schedule 'nope'; available:"):
        named_schedule("nope")
