"""Port parity: local-3D attention, the attention transformer and the
denoiser (``world_modelz_tpu_torch.models``) against the JAX package.

Everything runs in f32 on the CPU, where the kernel wrapper takes its plain
version. The attention core is compared within 1e-5 absolute: the same
masked softmax over the same keys, summed in another order (values are
O(1), so f32 rounding leaves ~1e-6). Logits after a 2-layer stack are
compared within 1e-4: the rounding of LayerNorm, GELU and five matmuls per
layer adds up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.kernels.local3d import local3d_attention_pallas  # noqa: E402
from world_modelz_tpu.models import attention as jattn  # noqa: E402
from world_modelz_tpu.models.video import (  # noqa: E402
    VqVideoDiffusionModel as JaxDenoiser,
)
from world_modelz_tpu.utils import torch_export  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.kernels import local3d_attention_fwd  # noqa: E402
from world_modelz_tpu_torch.models import VqVideoDiffusionModel  # noqa: E402
from world_modelz_tpu_torch.models import attention as tattn  # noqa: E402

ATTN_TOL = 1e-5
LOGIT_TOL = 1e-4


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


# (extents, heads, (B, S, H, W, inner)); the asymmetric cases are those of
# tests/test_kernels.py
ATTN_CASES = [
    ((1, 1, 1), 2, (2, 4, 4, 4, 16)),
    ((1, 2, 1), 2, (1, 5, 4, 5, 16)),
    ((2, 1, 0), 1, (1, 5, 3, 4, 8)),
    ((3, 1, 1), 1, (1, 6, 4, 4, 32)),
]


@pytest.mark.parametrize("extents,heads,shape", ATTN_CASES)
def test_local3d_attention_matches_jax(extents, heads, shape):
    q, k, v = _qkv(sum(shape), shape)
    ref = np.asarray(jattn.local3d_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), extents, heads))
    got = tattn.local3d_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        extents, heads)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("extents,heads,shape", ATTN_CASES[:3])
def test_local3d_wrapper_matches_pallas_interpret(extents, heads, shape):
    """The CPU wrapper (plain version) against the Pallas forward kernel run
    in interpret mode, as tests/test_kernels.py runs it."""
    q, k, v = _qkv(sum(shape) + 1, shape)
    ref = np.asarray(local3d_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), extents, heads, True))
    got = local3d_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        extents, heads)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATTN_TOL, rtol=0)


def test_local3d_attention_is_a_window_softmax():
    """Against a direct loop over each query's window: the definition the
    CUDA kernel walks (|ds|<=es in the clip, |dh|<=eh, |dw|<=ew in the
    frame), independent of the shift-stack-and-mask formulation."""
    extents, heads = (1, 1, 2), 2
    b, s, h, w, dh = 1, 3, 3, 4, 4
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, (b, s, h, w, heads * dh)))
    got = tattn.local3d_attention(q, k, v, extents, heads)
    want = torch.zeros_like(got)
    es, eh, ew = extents
    for n in range(heads):
        c = slice(n * dh, (n + 1) * dh)
        for si in range(s):
            for hi in range(h):
                for wi in range(w):
                    keys = [
                        (ss, hh, ww)
                        for ss in range(max(si - es, 0), min(si + es, s - 1) + 1)
                        for hh in range(max(hi - eh, 0), min(hi + eh, h - 1) + 1)
                        for ww in range(max(wi - ew, 0), min(wi + ew, w - 1) + 1)
                    ]
                    kk = torch.stack([k[0, a, bb, cc, c] for a, bb, cc in keys])
                    vv = torch.stack([v[0, a, bb, cc, c] for a, bb, cc in keys])
                    p = torch.softmax(kk @ q[0, si, hi, wi, c] * dh**-0.5, 0)
                    want[0, si, hi, wi, c] = p @ vv
    torch.testing.assert_close(got, want, atol=ATTN_TOL, rtol=0)


def test_feedforward_matches_flax():
    """GELU is the tanh approximation (flax's nn.gelu)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    jff = jattn.FeedForward(24)
    params = jff.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref = np.asarray(jff.apply({"params": params}, jnp.asarray(x)))
    ff = tattn.FeedForward(16, 24)
    sd = {}
    convert._linear(sd, "net.0", params["Dense_0"])
    convert._linear(sd, "net.3", params["Dense_1"])
    ff.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = ff(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# (dim, heads, dim_head, extents): the serving layout (one head, no
# ``to_out`` when dim_head == dim) and a multi-head one with ``to_out``
DENOISER_CASES = [
    (16, 1, 16, (1, 1, 1)),
    (32, 2, 16, (1, 2, 1)),
]
S, GRID, K, DEPTH, MLP = 3, 4, 16, 2, 24


def _denoiser_pair(dim, heads, dim_head, extents, seed=0):
    jm = JaxDenoiser(
        data_shape=(S, GRID, GRID), dim=dim, num_classes=K, extents=extents,
        depth=DEPTH, dim_head=dim_head, mlp_dim=MLP, heads=heads,
        backend="xla",
    )
    params = jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, S, GRID, GRID), jnp.int32)
    )["params"]
    # non-trivial LayerNorm and bias values, so a dropped term shows
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        params,
    )
    pm = VqVideoDiffusionModel(
        (S, GRID, GRID), dim, K, extents, DEPTH, dim_head, MLP, heads=heads,
        device="cpu",
    )
    pm.load_state_dict(convert.video_state_dict_from_params(params), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("dim,heads,dim_head,extents", DENOISER_CASES)
def test_denoiser_logits_match_flax(dim, heads, dim_head, extents):
    jm, params, pm = _denoiser_pair(dim, heads, dim_head, extents)
    assert (pm.transformer.layers[0][0].fn.to_out is None) == (
        heads == 1 and dim_head == dim)
    tokens = np.random.default_rng(1).integers(
        0, K + 1, size=(2, S, GRID, GRID)).astype(np.int32)
    tokens[:, -1] = K  # the mask class
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = pm(torch.from_numpy(tokens))
    assert tuple(got.shape) == ref.shape == (2, GRID, GRID, K)
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_TOL, rtol=0)


def test_transformer_features_match_flax():
    """The stack alone, with the query-not-normed quirk (only the k/v input
    of each attention block is LayerNormed)."""
    jm, params, pm = _denoiser_pair(*DENOISER_CASES[1], seed=2)
    jt = jattn.Local3dAttentionTransformer(
        data_shape=(S, GRID, GRID), dim=32, num_classes=K + 1,
        extents=DENOISER_CASES[1][3], depth=DEPTH, heads=2, dim_head=16,
        mlp_dim=MLP, backend="xla",
    )
    tokens = np.random.default_rng(3).integers(
        0, K + 1, size=(1, S, GRID, GRID)).astype(np.int32)
    ref = np.asarray(jt.apply(
        {"params": params["transformer"]}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = pm.transformer(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_TOL, rtol=0)


def test_convert_video_matches_torch_export():
    """The port's bridge writes exactly the keys and values of the JAX
    package's reference exporter."""
    _, params, pm = _denoiser_pair(*DENOISER_CASES[1])
    ref = torch_export.video_state_dict_from_params(params)
    got = convert.video_state_dict_from_params(params)
    assert sorted(got) == sorted(ref) == sorted(pm.state_dict())
    for key, val in ref.items():
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)


def test_local3d_wrapper_rejects_what_the_kernel_cannot_take():
    q = torch.zeros(1, 2, 2, 2, 8)
    with pytest.raises(ValueError):
        local3d_attention_fwd(q, q[..., :4], q, (1, 1, 1), 1)
    with pytest.raises(ValueError):
        local3d_attention_fwd(q, q, q, (1, 1, 1), 3)
    # a tensor on neither the CPU nor CUDA: no silent plain version
    m = torch.empty(1, 2, 2, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        local3d_attention_fwd(m, m, m, (1, 1, 1), 1)


def test_denoiser_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VqVideoDiffusionModel((S, GRID, GRID), 16, K, (1, 1, 1), 1, 16, MLP)
