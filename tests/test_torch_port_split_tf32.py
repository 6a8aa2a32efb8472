"""Port parity: the split-TF32 design of the f32 flash forward
(csrc/flash_fwd.cu:flash_fwd_tf32_kernel), emulated on the CPU, against the
stock Pallas TPU forward in f32.

The kernel takes its products on the tensor cores in TF32, which keeps 10
mantissa bits. Each operand x is split into hi = tf32(x) and lo = tf32(x -
hi), rounded as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from
zero), and each product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b,
summed in f32 (on the card, S's three products of each 8-deep step and P V
of each 64-key step are summed apart and added to the running sums in f32,
since the tensor cores' own adds are less exact). The emulation here
follows the kernel step by step: 64-key
steps with an online softmax (running max and sum, the accumulator
rescaled as the max moves), P split in registers for P V. The JAX side runs
``_flash_dense_attention`` in f32 on the CPU in TPU interpret mode, as
tests/test_torch_port_forward_bf16.py runs it.

Tolerances, times max(1, max |x|): the split emulation within 1e-5 of the
stock f32 forward (f32 sums in another order); one TF32 product a step,
the design the kernel does not take, breaks the card's 1e-4 gate
(chip_smoke.py F32_TOL) once the scores are sharper (q x 4), which is why
the kernel takes three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from world_modelz_tpu.models.attention import _flash_dense_attention

SPLIT_TOL = 1e-5
CARD_F32_TOL = 1e-4  # chip_smoke.py F32_TOL
STEP = 64  # keys of a kernel step


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on the int32 view: the magnitude rounded to 10
    mantissa bits, ties away from zero, the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32(x - hi)


def tf32_product(a: np.ndarray, b: np.ndarray, products: int) -> np.ndarray:
    """a @ b as the kernel takes it: three TF32 products, small terms
    first (lo hi, hi lo, hi hi), or one (hi hi); each TF32 product is exact
    in f32, and the sums are f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if products == 3 else [(ah, bh)]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for x, y in terms:
        out = out + (x.astype(np.float64) @ y.astype(np.float64)).astype(np.float32)
    return out


def split_tf32_attention(q, k, v, scale, products=3):
    """The kernel's forward for (B, H, N, D) f32 numpy operands: per 64-key
    step S = Q K^T in TF32 products, m' = max(m, max s), P = exp(s - m'),
    l = l exp(m - m') + sum P, acc = acc exp(m - m') + P V (P split too);
    out = acc / l, lse = m + log l."""
    b, h, n, d = q.shape
    out = np.empty_like(q)
    lse = np.empty((b, h, n), np.float32)
    for bi in range(b):
        for hi in range(h):
            m = np.full((n, 1), -np.inf, np.float32)
            l = np.zeros((n, 1), np.float32)
            acc = np.zeros((n, d), np.float32)
            for k0 in range(0, n, STEP):
                kk, vv = k[bi, hi, k0:k0 + STEP], v[bi, hi, k0:k0 + STEP]
                s = tf32_product(q[bi, hi], kk.T, products) * np.float32(scale)
                m_new = np.maximum(m, s.max(-1, keepdims=True))
                corr = np.exp(m - m_new)
                p = np.exp(s - m_new)
                l = l * corr + p.sum(-1, keepdims=True, dtype=np.float32)
                acc = acc * corr + tf32_product(p, vv, products)
                m = m_new
            out[bi, hi] = acc * (np.float32(1) / l)
            lse[bi, hi] = (m + np.log(l))[:, 0]
    return out, lse


def _operands(shape, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    return (q * np.float32(q_scale)).astype(np.float32), k, v


def _stock_f32(q, k, v, scale):
    with pltpu.force_tpu_interpret_mode():
        out = _flash_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    out = np.asarray(out)
    assert out.dtype == np.float32
    return out


def _rel_err(got, want):
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32's unit in the last place at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - np.float32(2.0**-23),
                  one + 3 * ulp / 2, np.float32(3.0)], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0], np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    rng = np.random.default_rng(0)
    y = rng.normal(size=10_000).astype(np.float32) * np.float32(1e3)
    hi, lo = split(y)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.abs(y - hi).max() <= 2.0**-11 * np.abs(y).max()
    # hi + lo keeps ~21 bits: within 2^-21 of x, relative
    assert np.all(np.abs((hi.astype(np.float64) + lo) - y) <= 2.0**-21 * np.abs(y))


@pytest.mark.parametrize("shape", [
    (1, 2, 512, 64), (1, 1, 256, 128),
    (1, 2, 200, 64), (2, 1, 320, 128),  # a last step short of 64 keys
])
def test_split_tf32_forward_matches_the_stock_f32_forward(shape):
    d = shape[-1]
    q, k, v = _operands(shape, sum(shape))
    want = _stock_f32(q, k, v, d**-0.5)
    out, lse = split_tf32_attention(q, k, v, d**-0.5)
    assert _rel_err(out, want) <= SPLIT_TOL
    # lse against float64
    s = np.einsum("bhnd,bhmd->bhnm", q.astype(np.float64), k.astype(np.float64)) * d**-0.5
    smax = s.max(-1)
    want_lse = smax + np.log(np.exp(s - smax[..., None]).sum(-1))
    np.testing.assert_allclose(lse, want_lse, rtol=0, atol=1e-5)


def test_one_tf32_product_breaks_the_f32_gate_and_three_do_not():
    """At q x 4 (sharper scores) one TF32 product a step is ~4e-3 off the
    stock f32 forward, past the card's 1e-4 gate; the three-product split
    stays within 1e-5."""
    shape = (1, 2, 512, 64)
    q, k, v = _operands(shape, 3, q_scale=4.0)
    want = _stock_f32(q, k, v, 0.125)
    one, _ = split_tf32_attention(q, k, v, 0.125, products=1)
    three, _ = split_tf32_attention(q, k, v, 0.125, products=3)
    assert _rel_err(one, want) > CARD_F32_TOL
    assert _rel_err(three, want) <= SPLIT_TOL
