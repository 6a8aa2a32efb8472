"""Port parity: where the bf16 fused block rounds, against the TPU block.

The TPU kernel world_modelz_tpu/kernels/local3d_block.py:_block_kernel
rounds k = T(x wk), v = T(T(x wv) + bv), q = T(q_in wq) (:151-159), the
attention weights normalised first, P = T(p / sum p) (:196), the attention
output, and out = T(a wo + bo) with bo added in f32 (:212-215). The port's
plain version (``local3d_block_reference``) rounds at the same points, and
the card holds the CUDA kernel to it bitwise (chip_smoke.py,
check_local3d_block). The JAX side runs the Pallas kernel on the CPU in
interpret mode, on weights scaled by fan_in^-1/2 so that activations stay
O(1).

Tolerance: 2^-7 x max |out|, one bf16 rounding step of the largest value
(the products and the softmax sum in another order, which may move a
rounding); and at least 99% of the outputs bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.kernels import local3d_block as jblock  # noqa: E402
from world_modelz_tpu_torch.kernels import local3d_block_reference  # noqa: E402

TOL = 2.0**-7
EQUAL_FRACTION = 0.99


def _operands(seed, b, s, h, w, dim, heads, dh):
    """x_kv, q_in, wk, wv, bv, wq, wo, bo in the JAX layout (weights (in,
    out)), each weight scaled by fan_in^-1/2, rounded to bf16."""
    rng = np.random.default_rng(seed)
    inner = heads * dh

    def f(*shape, fan_in=1):
        x = (rng.normal(size=shape) * fan_in**-0.5).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()

    return (f(b, s, h, w, dim), f(b, s, h, w, dim), f(dim, inner, fan_in=dim),
            f(dim, inner, fan_in=dim), f(inner, fan_in=dim), f(dim, inner, fan_in=dim),
            f(inner, dim, fan_in=inner), f(dim, fan_in=inner))


@pytest.mark.parametrize("shape,dim,heads,dh,extents", [
    ((2, 4, 4, 4), 24, 2, 8, (1, 1, 1)),
    ((1, 6, 8, 8), 64, 1, 64, (3, 1, 1)),
    ((2, 6, 8, 8), 96, 1, 128, (3, 1, 1)),
    ((1, 6, 8, 8), 40, 1, 64, (3, 1, 1)),  # a width that is not a multiple of 16
    ((1, 6, 8, 8), 64, 2, 64, (1, 2, 1)),  # two heads, an asymmetric window
    ((1, 6, 8, 8), 196, 2, 32, (1, 2, 1)),  # a width that is not a multiple of 8
])
def test_plain_bf16_block_rounds_where_the_tpu_block_does(shape, dim, heads, dh, extents):
    ops = _operands(sum(shape) + dim, *shape, dim, heads, dh)
    want = jblock.local3d_block(*(jnp.asarray(a, jnp.bfloat16) for a in ops), extents,
                                heads, True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    x, q, wk, wv, bv, wq, wo, bo = (torch.from_numpy(a).to(torch.bfloat16) for a in ops)
    got = local3d_block_reference(x, q, wk.T.contiguous(), wv.T.contiguous(), bv,
                                  wq.T.contiguous(), wo.T.contiguous(), bo, extents, heads)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()))
    equal = float((got == want).mean())
    assert equal >= EQUAL_FRACTION, f"{equal:.4f} bitwise equal"
