"""Port parity: the bf16 flash backward's rounding points, against the
stock TPU kernels.

The stock Pallas TPU backward (jax/experimental/pallas/ops/tpu/
flash_attention.py) keeps every sum in f32 but casts P and dS to the
operand dtype before the products that consume them: P * (1/l) for dV
(:900), dS * scale for dK (:918) and for dQ (:1258), with di = rowsum(o *
do) in f32 (:273). The JAX side is the JAX package's
``_flash_dense_attention`` (the stock kernels, N padded to 128 and fenced
off with segment ids) differentiated by ``jax.vjp`` and run on the CPU
under ``pltpu.force_tpu_interpret_mode``; a jnp rendition of the same
arithmetic, written here, is held as well. The port's side is the plain
versions ``dense_attention_bwd_dq`` / ``_dkv``, which the CUDA tensor-core
kernels are held to on the card. Both sides take the same bf16 operands
and the same forward output o (the backward's input: the stock forward
also rounds P before P V, which the port's forward does not yet). Tolerance:
2^-7 x max |x|, at least one bf16 rounding step of the largest value (the
exponentials and the f32 sums run in another order, which may move a
rounding of P or dS); and at least 99% of dq, dk and dv bitwise equal
(~99.8% measured; P and dS kept in f32 give ~57%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from world_modelz_tpu.models.attention import _flash_dense_attention  # noqa: E402
from world_modelz_tpu_torch.kernels import dense_attention as kd  # noqa: E402
from world_modelz_tpu_torch.models import attention as pa  # noqa: E402

TOL = 2.0**-7
EQUAL_FRACTION = 0.99


def _stock_vjp(q, k, v, g, sm_scale):
    """(o, dq, dk, dv) from the stock TPU kernels in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: _flash_dense_attention(a, b, c, sm_scale),
                         q, k, v)
        return (o, *vjp(g))


def _dot(spec, a, b):
    """A product of bf16 operands with f32 sums (preferred_element_type
    f32): bf16 values widen to f32 exactly."""
    return jnp.einsum(spec, a.astype(jnp.float32), b.astype(jnp.float32))


def _tpu_backward(q, k, v, o, do, sm_scale):
    """(dq, dk, dv, di) as the stock TPU backward kernels compute them, for
    (B, H, N, D) bf16 operands without padding."""
    s = _dot("bhqd,bhkd->bhqk", q, k) * sm_scale  # capped_logits, :844-858
    m = s.max(-1, keepdims=True)  # the forward's residuals m and l
    l = jnp.exp(s - m).sum(-1, keepdims=True)
    p = jnp.exp(s - m) * (1 / l)  # :882-885, :1226-1228
    di = jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32), axis=-1)  # :273
    dp = _dot("bhqd,bhkd->bhqk", do, v)  # :893-896
    ds = (dp - di[..., None]) * p * sm_scale  # :904-908
    dv = _dot("bhqk,bhqd->bhkd", p.astype(do.dtype), do)  # :900
    dk = _dot("bhqk,bhqd->bhkd", ds.astype(do.dtype), q)  # :918
    dq = _dot("bhqk,bhkd->bhqd", ds.astype(k.dtype), k)  # :1258
    return dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype), di


def _close(got, want, what):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()),
                               err_msg=what)
    equal = float((got == want).mean())
    assert equal >= EQUAL_FRACTION, f"{what}: {equal:.4f} bitwise equal"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [1000, 1024])
def test_plain_bf16_backward_rounds_where_the_tpu_kernels_do(n, d):
    b, h = 1, 2
    rng = np.random.default_rng(n + d)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    scale = d**-0.5
    to_jax = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v, g)]
    o_jax, *stock = _stock_vjp(*to_jax, scale)
    out = torch.from_numpy(np.array(o_jax.astype(jnp.float32))).to(torch.bfloat16)
    _, lse = pa.dense_attention_fwd(q, k, v, scale)
    dq, delta = pa.dense_attention_bwd_dq(q, k, v, out, g, lse, scale)
    dk, dv = pa.dense_attention_bwd_dkv(q, k, v, g, lse, delta, scale)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), stock):
        _close(got, want, f"{name} vs the stock kernels")
    *rendition, want_di = _tpu_backward(*to_jax[:3], o_jax, to_jax[3], scale)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), rendition):
        _close(got, want, f"{name} vs the jnp rendition")
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_di), rtol=0, atol=1e-5)
    # the wrappers take the same plain versions for CPU tensors
    w_dq, w_delta = kd.flash_bwd_dq(q, k, v, out, g, lse, scale)
    w_dk, w_dv = kd.flash_bwd_dkv(q, k, v, g, lse, delta, scale)
    for a, b_ in ((w_dq, dq), (w_delta, delta), (w_dk, dk), (w_dv, dv)):
        assert torch.equal(a, b_)


def test_kernel_layout_needs_16_byte_rows():
    """The tensor-core kernels copy 16 bytes at a time: a bf16 view whose n
    stride is 68 elements (a multiple of 4, not of 8) is refused; the same
    view in f32 (272 bytes) and a bf16 stride of 72 are taken."""
    view = torch.zeros((1, 2, 4, 68), dtype=torch.bfloat16)[..., :64]
    assert view.stride() == (544, 272, 68, 1)
    assert not kd.kernel_layout(view)
    assert kd.kernel_layout(torch.zeros((1, 2, 4, 72), dtype=torch.bfloat16)[..., :64])
    assert kd.kernel_layout(torch.zeros((1, 2, 4, 68))[..., :64])
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        kd._kernel_args([view] * 3)
