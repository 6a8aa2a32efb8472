"""Port parity: dense attention (``world_modelz_tpu_torch.models.attention``
``dense_attention*``, ``DenseAttention``, ``DenseTransformer`` and the
wrappers of ``kernels/dense_attention.py``) against the JAX package.

The stock TPU flash kernel has no interpret mode, so the JAX side is the
flash module's own references, ``mha_reference`` (with the padding to 128
and the segment ids of ``_flash_dense_attention``) and
``mha_reference_bwd``, and JAX's ``DenseAttention(backend="xla")``. The
port's side is the plain versions of the three kernels, which CPU tensors
take. Tolerances (f32): outputs, lse and delta 1e-5; gradients 1e-5 times
max(1, max |grad|) (the same f32 sums in another order); float64
gradcheck at its defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.experimental.pallas.ops.tpu import flash_attention as jflash  # noqa: E402

from world_modelz_tpu.models.attention import DenseTransformer as JaxDenseTransformer  # noqa: E402
from world_modelz_tpu_torch.kernels import dense_attention as kd  # noqa: E402
from world_modelz_tpu_torch.models import attention as pa  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-5


def _np(x):
    return np.array(jax.device_get(x))


def _qkvg(b, h, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(4)]


def _padded(arrays, n):
    """Pad N to a multiple of 128 with segment ids, as
    ``_flash_dense_attention`` does (attention.py:140-151)."""
    npad = -n % 128
    b = arrays[0].shape[0]
    padded = [jnp.pad(jnp.asarray(a), ((0, 0), (0, 0), (0, npad), (0, 0)))
              for a in arrays]
    seg = jnp.concatenate([jnp.zeros((b, n), jnp.int32),
                           jnp.ones((b, npad), jnp.int32)], axis=1)
    return padded, jflash.SegmentIds(q=seg, kv=seg)


def _close(got, want, tol, what):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("n", [40, 128, 200])
def test_plain_forward_matches_mha_reference_with_padding(n):
    b, h, d = 2, 2, 32
    q, k, v, _ = _qkvg(b, h, n, d, n)
    scale = d**-0.5
    (jq, jk, jv), seg = _padded((q, k, v), n)
    want = _np(jflash.mha_reference(jq, jk, jv, None, seg, sm_scale=scale))[:, :, :n]
    out_res, l, m = jflash.mha_reference_no_custom_vjp(
        jq, jk, jv, None, seg, sm_scale=scale, save_residuals=True)
    want_lse = _np(m + jnp.log(l))[:, :, :n]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = pa.dense_attention_fwd(*t, scale)
    _close(out, want, TOL, "out")
    _close(lse, want_lse, TOL, "lse")
    _close(pa.dense_attention(*t, scale), want, TOL, "xla branch")
    # the wrapper takes the plain version for CPU tensors
    w_out, w_lse = kd.flash_attention_fwd(*t, scale)
    assert torch.equal(w_out, out) and torch.equal(w_lse, lse)
    assert out.dtype == torch.float32 and lse.shape == (b, h, n)


@pytest.mark.parametrize("n", [40, 200])
def test_plain_split_backward_matches_mha_reference_bwd(n):
    """mha_reference_bwd takes sm_scale 1 only: q is pre-scaled, so its
    dq is d/d(scale q) and the port's dq is scale times it."""
    b, h, d = 2, 2, 32
    q, k, v, g = _qkvg(b, h, n, d, 10 + n)
    scale = d**-0.5
    (jq, jk, jv, jg), seg = _padded((q * scale, k, v, g), n)
    jo, l, m = jflash.mha_reference_no_custom_vjp(
        jq, jk, jv, None, seg, save_residuals=True)
    dq_r, dk_r, dv_r, _ = jflash.mha_reference_bwd(jq, jk, jv, None, seg, jo, l, m, jg)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    out, lse = pa.dense_attention_fwd(*t[:3], scale)
    dq, delta = pa.dense_attention_bwd_dq(*t[:3], out, t[3], lse, scale)
    dk, dv = pa.dense_attention_bwd_dkv(*t[:3], t[3], lse, delta, scale)
    _close(dq, scale * _np(dq_r)[:, :, :n], GRAD_TOL, "dq")
    _close(dk, _np(dk_r)[:, :, :n], GRAD_TOL, "dk")
    _close(dv, _np(dv_r)[:, :, :n], GRAD_TOL, "dv")
    _close(delta, (g * out.numpy()).sum(-1), TOL, "delta")
    # the wrappers take the plain versions for CPU tensors
    w_dq, w_delta = kd.flash_bwd_dq(*t[:3], out, t[3], lse, scale)
    w_dk, w_dv = kd.flash_bwd_dkv(*t[:3], t[3], lse, delta, scale)
    for a, b_ in ((w_dq, dq), (w_delta, delta), (w_dk, dk), (w_dv, dv)):
        assert torch.equal(a, b_)


def test_split_backward_matches_jax_vjp():
    b, h, n, d = 1, 3, 50, 64
    q, k, v, g = _qkvg(b, h, n, d, 7)
    scale = d**-0.5

    def ref(q, k, v):
        return jflash.mha_reference_no_custom_vjp(q, k, v, None, sm_scale=scale)

    _, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    want = [_np(x) for x in vjp(jnp.asarray(g))]
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = kd.flash_attention(*t, scale)
    out.backward(torch.from_numpy(g))
    for name, p, w in zip("qkv", t, want):
        _close(p.grad, w, GRAD_TOL, f"d{name}")


def test_flash_function_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 9, 4), generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(lambda *a: kd.flash_attention(*a, 0.5), (q, k, v))


def test_bf16_plain_versions_keep_f32_statistics():
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkvg(1, 2, 33, 64, 3))
    out, lse = pa.dense_attention_fwd(q, k, v, 0.125)
    dq, delta = pa.dense_attention_bwd_dq(q, k, v, out, g, lse, 0.125)
    dk, dv = pa.dense_attention_bwd_dkv(q, k, v, g, lse, delta, 0.125)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert lse.dtype == delta.dtype == torch.float32
    f32 = pa.dense_attention_fwd(q.float(), k.float(), v.float(), 0.125)[0]
    assert float((out.float() - f32).abs().max()) <= 2**-8 * float(f32.abs().max())


def test_kernel_argument_checks():
    """What the CUDA wrappers check before a launch (host code, testable
    here): dtype, head size, layout; the fused-QKV head views pass."""
    b, n, h, d = 2, 8, 2, 64
    qkv = torch.zeros((b, n, 3 * h * d))
    views = [t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, -1)]
    strides, *rest = kd._kernel_args(views)
    assert list(strides)[:3] == [n * 3 * h * d, d, 3 * h * d]
    assert rest == [b, h, n, d, 0]
    with pytest.raises(ValueError, match="head sizes"):
        kd._kernel_args([torch.zeros((1, 1, 4, 32))] * 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kd._kernel_args([torch.zeros((1, 1, 4, 64), dtype=torch.float16)] * 3)
    with pytest.raises(ValueError, match="last dimension"):
        kd._kernel_args([torch.zeros((1, 1, 64, 4)).transpose(2, 3)] * 3)
    with pytest.raises(TypeError, match="lse"):
        kd._kernel_args(views, (torch.zeros((b, h, n), dtype=torch.float64),))
    with pytest.raises(ValueError, match="one shape"):
        kd.flash_attention_fwd(views[0], views[1][:, :, :4], views[2], 0.1)
    with pytest.raises(ValueError, match="lse and delta"):
        kd.flash_bwd_dkv(*views, views[0], torch.zeros((b, h, n)),
                         torch.zeros((b, h, n + 1)), 0.1)
    meta = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kd.flash_attention_fwd(meta, meta, meta, 0.1)


# ------------------------------------------------ the modules, against JAX


def _jax_stack(depth, heads, dim_head, dim, mlp, n, seed):
    jm = JaxDenseTransformer(depth=depth, heads=heads, dim_head=dim_head,
                             mlp_dim=mlp, attn_backend="xla")
    x = np.random.default_rng(seed).normal(size=(2, n, dim)).astype(np.float32)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x)))
    return jm, params["params"], x


def _port_stack(params, depth, heads, dim_head, dim, mlp, backend):
    from world_modelz_tpu_torch import convert

    # the sparse model's bridge, on a tree with stand-in embeddings
    tree = {"transformer": params, "logit_proj": {"kernel": np.zeros((dim, 1)),
                                                  "bias": np.zeros(1)}}
    for name in ("embedding", "pos_emb_s", "pos_emb_h", "pos_emb_w"):
        tree[name] = {"embedding": np.zeros((1, dim))}
    sd = {k[len("transformer."):]: v
          for k, v in convert.sparse_state_dict_from_params(tree).items()
          if k.startswith("transformer.")}
    m = pa.DenseTransformer(dim, depth, heads, dim_head, mlp, attn_backend=backend)
    m.load_state_dict(sd, strict=True)
    return m


@pytest.mark.parametrize("backend", ["xla", "flash", "auto"])
@pytest.mark.parametrize("heads,dim_head,dim", [(2, 8, 16), (1, 16, 16)],
                         ids=["project_out", "no_to_out"])
def test_dense_transformer_matches_jax_forward_and_gradients(
        backend, heads, dim_head, dim):
    depth, mlp, n = 2, 24, 20
    jm, params, x = _jax_stack(depth, heads, dim_head, dim, mlp, n, heads)
    w = np.random.default_rng(1).normal(size=(2, n, dim)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x) * w)

    want_y = _np(jm.apply({"params": params}, jnp.asarray(x)))
    want_g, want_dx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    m = _port_stack(params, depth, heads, dim_head, dim, mlp, backend)
    assert (m.layers[0][0].fn.to_out is None) == (heads == 1 and dim_head == dim)
    tx = torch.from_numpy(x).requires_grad_()
    y = m(tx)
    _close(y, want_y, TOL, "out")
    (y * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, _np(want_dx), GRAD_TOL, "dx")
    want_sd = _port_stack(jax.device_get(want_g), depth, heads, dim_head, dim, mlp,
                          "xla").state_dict()
    for name, p in m.named_parameters():
        _close(p.grad, want_sd[name].numpy(), GRAD_TOL, name)


def test_backend_routing_on_cpu_tensors():
    """auto takes the kernels only for CUDA tensors with N >= 1024 and no
    dropout (JAX's own xla routing otherwise); flash takes the Function
    (the plain versions on the CPU) and refuses dropout."""
    x_long = torch.zeros((1, pa.FLASH_MIN_TOKENS, 16))
    auto = pa.DenseAttention(16, heads=2, dim_head=8, backend="auto")
    assert not auto.uses_flash(x_long)
    assert pa.DenseAttention(16, heads=2, dim_head=8, backend="flash").uses_flash(x_long[:, :3])
    assert not pa.DenseAttention(16, heads=2, dim_head=8, backend="xla").uses_flash(x_long)
    with pytest.raises(ValueError, match="dropout"):
        pa.DenseAttention(16, backend="flash", dropout=0.1)
    with pytest.raises(ValueError, match="backend"):
        pa.DenseAttention(16, backend="pallas")
    # dropout on the attention weights follows train()/eval()
    drop = pa.DenseAttention(16, heads=2, dim_head=8, dropout=0.5).eval()
    x = torch.randn((1, 6, 16), generator=torch.Generator().manual_seed(0))
    assert torch.equal(drop(x), drop(x))
    drop.train()
    torch.manual_seed(0)
    assert not torch.equal(drop(x), drop.eval()(x))
