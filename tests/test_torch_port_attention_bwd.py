"""Port parity: the local-3D attention backward (the plain versions of the
split kernel pair, and the autograd Function that routes to them on CPU
tensors) and the denoiser's parameter gradients, against the JAX package.

Everything runs on the CPU in f32, where the Function's forward and
backward take the plain versions of the three kernels. Gradients of the
attention core are compared with rtol 5e-4, atol 5e-5, the tolerance of
tests/test_kernels.py for the Pallas backward (f32 sums in another order
over the same window). lse and delta are held within 1e-5 of a float64
reference computed here. The denoiser's parameter gradients (2 layers)
agree within 1e-4 absolute: the rounding of LayerNorm, GELU and five
matmuls per layer adds up, as for its logits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.kernels.local3d import (  # noqa: E402
    _bwd_impl_split,
    local3d_attention_pallas,
)
from world_modelz_tpu.models.video import (  # noqa: E402
    VqVideoDiffusionModel as JaxDenoiser,
)
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.kernels import (  # noqa: E402
    local3d_attention,
    local3d_bwd_dkv,
    local3d_bwd_dq,
)
from world_modelz_tpu_torch.models import VqVideoDiffusionModel  # noqa: E402
from world_modelz_tpu_torch.models import attention as tattn  # noqa: E402

RTOL, ATOL = 5e-4, 5e-5
STAT_TOL = 1e-5
GRAD_TOL = 1e-4

# (extents, heads, (B, S, H, W, inner), split bands (qt, kt)): the (1,1,1)
# 3x3 grid of tests/test_kernels.py, two heads with asymmetric extents,
# and a banded split call
CASES = [
    ((1, 1, 1), 1, (1, 3, 3, 3, 8), (None, None)),
    ((2, 1, 0), 2, (2, 5, 3, 4, 16), (None, None)),
    ((1, 2, 1), 2, (1, 4, 4, 5, 16), (None, None)),
    ((3, 1, 1), 1, (1, 4, 8, 8, 16), (4, 2)),
]
IDS = ["e111", "e210_h2", "e121_h2", "e311_banded"]


@functools.lru_cache(maxsize=None)
def _case(i):
    """Inputs and JAX's gradients of case i: jax.vjp of the Pallas kernel
    (interpret mode) with the cotangent g."""
    extents, heads, shape, _ = CASES[i]
    rng = np.random.default_rng(10 + i)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(
        lambda q, k, v: local3d_attention_pallas(q, k, v, extents, heads, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    grads = tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))
    return (q, k, v, g), grads


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_plain_split_backward_matches_jax_grad_of_pallas(i):
    extents, heads, _, _ = CASES[i]
    (q, k, v, g), want = _case(i)
    dq, lse, delta = tattn.local3d_attention_bwd_dq(*_t(q, k, v, g), extents, heads)
    dk, dv = tattn.local3d_attention_bwd_dkv(
        *_t(q, k, v, g), lse, delta, extents, heads)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_plain_split_backward_matches_jax_split_impl(i):
    """Against the JAX package's split pair called directly (interpret
    mode), banded where the case gives bands."""
    extents, heads, _, (qt, kt) = CASES[i]
    (q, k, v, g), _ = _case(i)
    want = _bwd_impl_split(
        *(jnp.asarray(a) for a in (q, k, v, g)), extents, heads, True, qt, kt)
    dq, lse, delta = local3d_bwd_dq(*_t(q, k, v, g), extents, heads)
    dk, dv = local3d_bwd_dkv(*_t(q, k, v, g), lse, delta, extents, heads)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_function_gradients_match_jax(i):
    """The autograd Function (``Local3dAttention``'s core) on CPU tensors:
    forward as the Pallas forward, gradients as jax's."""
    extents, heads, _, _ = CASES[i]
    (q, k, v, g), want = _case(i)
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    out = local3d_attention(qt, kt, vt, extents, heads)
    ref_out = local3d_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), extents, heads, True)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(ref_out), rtol=RTOL, atol=ATOL)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    for a, ref in zip(got, want):
        np.testing.assert_allclose(a.numpy(), ref, rtol=RTOL, atol=ATOL)


def _window_stats_f64(q, k, v, g, extents, heads):
    """lse and delta of every query by a direct loop over its window, in
    float64: the definition the CUDA kernel walks."""
    b, s, h, w, inner = q.shape
    dh = inner // heads
    es, eh, ew = extents
    lse = np.zeros((b, s, h, w, heads))
    delta = np.zeros_like(lse)
    for bi in range(b):
        for si in range(s):
            for hi in range(h):
                for wi in range(w):
                    rows = [
                        (ss, hh, ww)
                        for ss in range(max(si - es, 0), min(si + es, s - 1) + 1)
                        for hh in range(max(hi - eh, 0), min(hi + eh, h - 1) + 1)
                        for ww in range(max(wi - ew, 0), min(wi + ew, w - 1) + 1)
                    ]
                    for n in range(heads):
                        c = slice(n * dh, (n + 1) * dh)
                        kk = np.stack([k[bi, a, bb, cc, c] for a, bb, cc in rows])
                        vv = np.stack([v[bi, a, bb, cc, c] for a, bb, cc in rows])
                        sc = kk.astype(np.float64) @ q[bi, si, hi, wi, c] * dh**-0.5
                        m = sc.max()
                        p = np.exp(sc - m)
                        lse[bi, si, hi, wi, n] = m + np.log(p.sum())
                        dp = vv.astype(np.float64) @ g[bi, si, hi, wi, c]
                        delta[bi, si, hi, wi, n] = (p / p.sum()) @ dp
    return lse, delta


@pytest.mark.parametrize("i", [0, 1], ids=IDS[:2])
def test_lse_and_delta_match_float64_window_loop(i):
    extents, heads, _, _ = CASES[i]
    (q, k, v, g), _ = _case(i)
    _, lse, delta = local3d_bwd_dq(*_t(q, k, v, g), extents, heads)
    want_lse, want_delta = _window_stats_f64(q, k, v, g, extents, heads)
    assert lse.dtype == delta.dtype == torch.float32
    assert tuple(lse.shape) == want_lse.shape == q.shape[:4] + (heads,)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=STAT_TOL)
    np.testing.assert_allclose(delta.numpy(), want_delta, rtol=0, atol=STAT_TOL)


def test_function_gradcheck_float64():
    """Finite differences in float64 through the Function (the plain
    versions keep float64)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 3, 3, 2, 8))).requires_grad_()
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: local3d_attention(q, k, v, (1, 1, 0), 2), (q, k, v))


def test_backward_wrappers_reject_what_the_kernels_cannot_take():
    q = torch.zeros(1, 2, 2, 2, 8)
    stats = torch.zeros(1, 2, 2, 2, 1)
    with pytest.raises(ValueError):
        local3d_bwd_dq(q, q, q, q[..., :4], (1, 1, 1), 1)
    with pytest.raises(ValueError, match="lse and delta"):
        local3d_bwd_dkv(q, q, q, q, stats[..., :0], stats, (1, 1, 1), 1)
    m = torch.empty(1, 2, 2, 2, 64, device="meta")
    ms = torch.empty(1, 2, 2, 2, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        local3d_bwd_dq(m, m, m, m, (1, 1, 1), 1)
    with pytest.raises(ValueError, match="CUDA"):
        local3d_bwd_dkv(m, m, m, m, ms, ms, (1, 1, 1), 1)


# the denoiser: 2 layers, dim 32, 4x4 grid, two heads (with to_out)
S, GRID, K, DIM, HEADS, DIM_HEAD, MLP = 3, 4, 16, 32, 2, 16, 24


def test_denoiser_parameter_gradients_match_flax():
    extents = (1, 1, 1)
    jm = JaxDenoiser(
        data_shape=(S, GRID, GRID), dim=DIM, num_classes=K, extents=extents,
        depth=2, dim_head=DIM_HEAD, mlp_dim=MLP, heads=HEADS, backend="xla",
    )
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, S, GRID, GRID), jnp.int32)
    )["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        params,
    )
    tokens = rng.integers(0, K + 1, size=(2, S, GRID, GRID)).astype(np.int32)
    tokens[:, -1, :2] = K  # masked positions
    target = rng.integers(0, K, size=(2, GRID, GRID)).astype(np.int32)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(tokens), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.reshape(-1, K), jnp.asarray(target).reshape(-1)).mean()

    jgrads = jax.jit(jax.grad(loss_fn))(jax.tree_util.tree_map(jnp.asarray, params))
    want = convert.video_state_dict_from_params(jax.device_get(jgrads))

    pm = VqVideoDiffusionModel(
        (S, GRID, GRID), DIM, K, extents, 2, DIM_HEAD, MLP, heads=HEADS,
        device="cpu",
    ).train()
    pm.load_state_dict(convert.video_state_dict_from_params(params), strict=True)
    logits = pm(torch.from_numpy(tokens))
    torch.nn.functional.cross_entropy(
        logits.reshape(-1, K), torch.from_numpy(target).long().reshape(-1)
    ).backward()
    got = dict(pm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), want[name].numpy(), rtol=0, atol=GRAD_TOL,
            err_msg=name)
    for proj in ("to_q", "to_k", "to_v"):
        assert float(got[f"transformer.layers.0.0.fn.{proj}.weight"].grad.abs().max()) > 0
