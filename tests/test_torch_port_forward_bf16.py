"""Port parity: where the bf16 attention forwards round P, against the TPU
kernels.

The stock Pallas TPU flash forward (jax/experimental/pallas/ops/tpu/
flash_attention.py:_flash_attention_kernel) walks the keys in blocks of
512, 256 or 128 (the JAX package's ``_flash_dense_attention`` picks the
block) and rounds P = exp(s - m) to the operand dtype before P V, against
the running max m of each block, rescaling its f32 accumulator by l_corr /
l_next; a single block normalises P first. The local-3D TPU forward that
``_route_fwd`` picks rounds P unnormalised and divides P V by the sum
(``_attn_kernel_allframes``), or normalises P first (``_attn_kernel``,
``_attn_kernel_tiled``). The JAX side runs those kernels on the CPU in TPU
interpret mode; the port's side is the plain versions
(``dense_attention_fwd``, and ``local3d_attention_fwd``'s CPU path), which
the CUDA tensor-core kernels are held to on the card.

Tolerance: 2^-7 x max |out|, at least one bf16 rounding step of the
largest value (the exponentials and the f32 sums run in another order,
which may move a rounding of P or of the output); and at least 99% of the
outputs bitwise equal (measured 99.74-99.95% for the flash forward,
99.998-100% for local 3D). The same inputs with P kept in f32 stay below
99% (flash ~59%, local 3D ~64%), so the criterion tells the two apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

import jax.experimental.pallas.ops.tpu.flash_attention as stock  # noqa: E402

from world_modelz_tpu.kernels import local3d as jl3d  # noqa: E402
from world_modelz_tpu.models.attention import _flash_dense_attention  # noqa: E402
from world_modelz_tpu_torch.kernels import dense_attention as kd  # noqa: E402
from world_modelz_tpu_torch.kernels import local3d as kl  # noqa: E402
from world_modelz_tpu_torch.models import attention as pa  # noqa: E402

TOL = 2.0**-7
EQUAL_FRACTION = 0.99


def _bf16_operands(shape, seed):
    rng = np.random.default_rng(seed)
    port = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]
    return port, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in port]


def _equal_share(got, want):
    return float((got.float().numpy() == np.asarray(want.astype(jnp.float32))).mean())


def _close(got, want, what):
    want32 = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want32, rtol=0,
                               atol=TOL * float(np.abs(want32).max()), err_msg=what)
    equal = _equal_share(got, want)
    assert equal >= EQUAL_FRACTION, f"{what}: {equal:.4f} bitwise equal"


def _stock_forward(q, k, v, scale):
    """out and the residuals (l, m) of the stock TPU forward in interpret
    mode, on the JAX package's padding and block sizes."""
    with pltpu.force_tpu_interpret_mode():
        out = _flash_dense_attention(q, k, v, scale)
        n = q.shape[2]
        block, padded = kd.flash_block_size(n)
        pad = lambda t: jnp.pad(t, ((0, 0), (0, 0), (0, padded - n), (0, 0)))  # noqa: E731
        seg = jnp.concatenate([jnp.zeros((q.shape[0], n), jnp.int32),
                               jnp.ones((q.shape[0], padded - n), jnp.int32)], axis=1)
        _, l, m = stock._flash_attention_impl(
            pad(q), pad(k), pad(v), None, stock.SegmentIds(q=seg, kv=seg), True, False,
            scale, 1, block, block, block, False)
    return out, (m + jnp.log(l))[:, :, :n]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [1000, 1024])
def test_plain_flash_forward_rounds_where_the_stock_kernel_does(n, d):
    (q, k, v), jqkv = _bf16_operands((1, 2, n, d), n + d)
    scale = d**-0.5
    want, want_lse = _stock_forward(*jqkv, scale)
    out, lse = pa.dense_attention_fwd(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out, want, "out vs the stock forward")
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0, atol=1e-4)
    # the wrapper takes the same plain version for CPU tensors
    w_out, w_lse = kd.flash_attention_fwd(q, k, v, scale)
    assert torch.equal(w_out, out) and torch.equal(w_lse, lse)
    # P kept in f32 (the port's forward before) is told apart
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    f32_p = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(s, -1), v.float())
    assert _equal_share(f32_p.to(torch.bfloat16), want) < EQUAL_FRACTION


def test_single_block_normalises_before_rounding():
    """N = 256 is one stock block: P / l is rounded (the single-step
    kernel), which the blocked rescale would not reproduce."""
    (q, k, v), jqkv = _bf16_operands((1, 2, 256, 64), 7)
    assert kd.flash_block_size(256) == (256, 256)
    want, _ = _stock_forward(*jqkv, 0.125)
    out, _ = pa.dense_attention_fwd(q, k, v, 0.125)
    _close(out, want, "out vs the stock single-block forward")


def _local3d_pallas(jqkv, extents, heads):
    return jl3d.local3d_attention_pallas(*jqkv, extents, heads, True)


@pytest.mark.parametrize("shape,heads,extents,divide_after", [
    ((1, 6, 8, 8, 128), 1, (3, 1, 1), True),  # the m3 shape: all-frames
    ((2, 6, 8, 8, 128), 2, (1, 2, 1), True),
    ((1, 34, 2, 4, 64), 2, (1, 1, 1), False),  # > 32 frames: per-frame kernel
])
def test_plain_local3d_forward_rounds_where_the_tpu_kernel_does(
        shape, heads, extents, divide_after):
    (q, k, v), jqkv = _bf16_operands(shape, sum(shape))
    dh = shape[-1] // heads
    # the shape goes where the test says, in the JAX package and the port
    band = jl3d.pick_allframes_band(*shape[1:4], extents, dh, 2)
    assert (band is not None) == divide_after
    assert kl.divides_after_product(shape, heads, extents, torch.bfloat16) == divide_after
    want = _local3d_pallas(jqkv, extents, heads)
    out = kl.local3d_attention_fwd(q, k, v, extents, heads)
    assert out.dtype == torch.bfloat16
    _close(out, want, "out vs local3d_attention_pallas")
    assert torch.equal(out, pa.local3d_attention_rounded(q, k, v, extents, heads,
                                                         divide_after))
    # P kept in f32 (the CUDA-core kernel's arithmetic) is told apart
    f32_p = pa.local3d_attention(q.float(), k.float(), v.float(), extents, heads)
    assert _equal_share(f32_p.to(torch.bfloat16), want) < EQUAL_FRACTION


def test_flash_block_size_is_the_jax_packages(monkeypatch):
    """The block and padding ``_flash_dense_attention`` hands the stock
    kernel, captured by a stand-in for it, over N = 1 ... 2,100."""
    seen = {}

    def capture(q, k, v, segment_ids=None, causal=False, sm_scale=1.0,
                block_sizes=None):
        seen["block"], seen["padded"] = block_sizes.block_k, q.shape[2]
        return q

    monkeypatch.setattr(stock, "flash_attention", capture)
    for n in list(range(1, 2200, 131)) + [128, 256, 384, 512, 640, 1024, 1536, 2048]:
        _flash_dense_attention(*(jnp.zeros((1, 1, n, 8)),) * 3, 1.0)
        assert kd.flash_block_size(n) == (seen["block"], seen["padded"]), n


def test_allframes_band_is_the_jax_packages():
    """The port's copy of the forward ``pick_allframes_band`` against the
    JAX package's, over grids, extents, head sizes and item sizes."""
    for s in (1, 2, 6, 16, 32, 33):
        for h, w in ((4, 4), (8, 8), (16, 16), (32, 32), (8, 16), (64, 64)):
            for ext in ((3, 1, 1), (1, 2, 1), (0, 0, 0), (2, 3, 2)):
                for dh in (32, 64, 128, 256):
                    for itemsize in (2, 4):
                        args = (s, h, w, ext, dh, itemsize)
                        assert kl.allframes_band(*args) == jl3d.pick_allframes_band(*args), args


@pytest.mark.parametrize("dtype,dh", [
    (torch.bfloat16, 64),
    (torch.bfloat16, 128),
    (torch.float32, 128),
    (torch.bfloat16, 32),
    (torch.bfloat16, 96),
    (torch.bfloat16, 256),
])
def test_local3d_forward_route(dtype, dh):
    """Where the forward rounds P follows the TPU forward for the shape at
    every head size and dtype, whichever CUDA kernel the C entry picks
    (tensor cores for bf16 at 64 and 128, CUDA cores otherwise): the
    training shape divides P V by the sum as the all-frames kernel does, a
    34-frame clip normalises P first as the per-frame kernel does."""
    assert kl.divides_after_product((8, 6, 8, 8, 2 * dh), 2, (3, 1, 1), dtype)
    assert not kl.divides_after_product((1, 34, 2, 4, 2 * dh), 2, (1, 1, 1), dtype)
