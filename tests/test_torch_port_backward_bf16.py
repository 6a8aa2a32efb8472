"""Port parity: where the bf16 local-3D backward rounds P and dS and sums
dK and dV, against the TPU backward kernels.

Every TPU backward of world_modelz_tpu/kernels/local3d.py rounds the
normalised P and dS = P (dP - delta) to the operand dtype before their
products (``_bwd_kernel_allframes``, ``_bwd_kernel``, ``_bwd_kernel_tiled``,
and the split pair ``_bwd_kernel_dq`` / ``_bwd_kernel_dkv``, which rebuilds
P as exp(s - lse)), and applies the scale after the product. dK and dV are
one f32 sum on the all-frames and split routes; the per-frame kernel stores
each query frame's partial at the operand dtype before its fold adds them
in f32, the H-tiled kernel each query frame's and H tile's. The port's
plain versions (``local3d_attention_bwd_dq`` / ``_dkv``, which the CUDA
kernels are held to on the card) do the same where ``bwd_route`` says.
The JAX side runs on the CPU in interpret mode, through ``jax.vjp`` of
``local3d_attention_pallas`` (which routes by shape) or each route's
``_bwd_impl*`` called directly with small bands.

Tolerance: 2^-7 x max |x|, at least one bf16 rounding step of the largest
gradient (the exponentials and the f32 sums run in another order, which
may move a rounding); and at least 99% of dq, dk and dv bitwise equal
(measured 99.95-100%). The same inputs with P and dS kept in f32 (the
port's plain versions before) stay below 99% (measured 51-61%), and so
does the per-frame route summed in one f32 sum, so the criterion tells
them apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.kernels import local3d as jl3d  # noqa: E402
from world_modelz_tpu_torch.kernels import local3d as kl  # noqa: E402
from world_modelz_tpu_torch.models import attention as pa  # noqa: E402

TOL = 2.0**-7
EQUAL_FRACTION = 0.99


def _bf16_operands(shape, seed):
    """q, k, v, g in bf16 from one numpy stream, for the port and JAX."""
    rng = np.random.default_rng(seed)
    port = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
            for _ in range(4)]
    return port, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in port]


def _equal_share(got, want):
    return float((got.float().numpy() == np.asarray(want.astype(jnp.float32))).mean())


def _close(got, want, what):
    want32 = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want32, rtol=0,
                               atol=TOL * float(np.abs(want32).max()), err_msg=what)
    equal = _equal_share(got, want)
    assert equal >= EQUAL_FRACTION, f"{what}: {equal:.4f} bitwise equal"


def _plain(ops, extents, heads, partial_rows=None):
    """The plain pair; ``partial_rows`` sums dK and dV as another route
    would (None: the shape's own, as ``bwd_route`` says)."""
    dq, lse, delta = pa.local3d_attention_bwd_dq(*ops, extents, heads)
    if partial_rows is None:
        dk, dv = pa.local3d_attention_bwd_dkv(*ops, lse, delta, extents, heads)
    else:
        dk, dv = pa._local3d_bwd_dkv(*ops, lse, delta, extents, heads, partial_rows)
    return dq, dk, dv


def _f32_rendition(ops, extents, heads):
    """P and dS kept in f32, one f32 sum: the plain versions fed f32
    copies, rounded at the end."""
    dq, dk, dv = _plain([t.float() for t in ops], extents, heads)
    return [t.to(torch.bfloat16) for t in (dq, dk, dv)]


@pytest.mark.parametrize("shape,heads,extents,kind", [
    ((1, 6, 8, 8, 128), 1, (3, 1, 1), kl.BWD_ALLFRAMES),  # the m3 shape
    ((1, 34, 2, 4, 64), 2, (1, 1, 1), kl.BWD_PER_FRAME),  # > 32 frames
], ids=["m3_allframes", "clip34_per_frame"])
def test_plain_backward_rounds_where_the_tpu_backward_does(shape, heads, extents, kind):
    ops, jops = _bf16_operands(shape, sum(shape))
    route = kl.bwd_route(shape, heads, extents, torch.bfloat16)
    assert route.kind == kind
    _, vjp = jax.vjp(
        lambda q, k, v: jl3d.local3d_attention_pallas(q, k, v, extents, heads, True),
        *jops[:3])
    want = vjp(jops[3])
    got = _plain(ops, extents, heads)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, f"{name} vs jax.vjp of local3d_attention_pallas")
    for name, a, b in zip(("dq", "dk", "dv"), _f32_rendition(ops, extents, heads), want):
        assert _equal_share(a, b) < EQUAL_FRACTION, f"f32 P and dS {name}"
    if route.partial_rows:
        # one f32 sum where the per-frame kernel rounds each frame's slab
        _, dk, dv = _plain(ops, extents, heads, partial_rows=0)
        assert _equal_share(dk, want[1]) < EQUAL_FRACTION
        assert _equal_share(dv, want[2]) < EQUAL_FRACTION


def _allframes(q, k, v, g, extents, heads):
    return jl3d._bwd_impl_allframes(q, k, v, g, extents, heads, True, 2)


def _per_frame(q, k, v, g, extents, heads):
    return jl3d._bwd_impl(q, k, v, g, extents, heads, True, 2)


def _split(q, k, v, g, extents, heads):
    return jl3d._bwd_impl_split(q, k, v, g, extents, heads, True, 2, 2)


def _tiled(q, k, v, g, extents, heads):
    return jl3d._bwd_impl_tiled(q, k, v, g, extents, heads, True, 4)


# each TPU backward called directly at a banded size, and the partial rows
# the port sums it with: (B, S, H, W, inner), heads, extents
ROUTES = [
    (_allframes, 0, (1, 4, 4, 8, 64), 2, (1, 1, 1)),
    (_per_frame, 4, (1, 4, 4, 8, 64), 2, (1, 1, 1)),
    (_split, 0, (1, 4, 4, 8, 64), 2, (1, 1, 1)),
    (_tiled, 4, (1, 4, 8, 4, 64), 2, (1, 1, 1)),
]


@pytest.mark.parametrize("impl,partial_rows,shape,heads,extents", ROUTES,
                         ids=["allframes", "per_frame", "split", "tiled"])
def test_plain_backward_matches_each_tpu_route(impl, partial_rows, shape, heads, extents):
    ops, jops = _bf16_operands(shape, 3 + sum(shape))
    want = impl(*jops, extents, heads)
    got = _plain(ops, extents, heads, partial_rows)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, f"{name} vs {impl.__name__}")
    for name, a, b in zip(("dq", "dk", "dv"), _f32_rendition(ops, extents, heads), want):
        assert _equal_share(a, b) < EQUAL_FRACTION, f"f32 P and dS {name}"


def _jax_route(s, h, w, extents, dh, itemsize):
    """``_route_bwd``'s choice, from the JAX package's own picks."""
    if jl3d.pick_allframes_band(s, h, w, extents, dh, itemsize, bwd=True) is not None:
        return kl.BWD_ALLFRAMES, 0
    if jl3d.pick_frame_band(s, h, w, extents, dh, True, itemsize) is not None:
        return kl.BWD_PER_FRAME, h
    if jl3d.pick_split_bands(s, h, w, extents, dh, itemsize) is not None:
        return kl.BWD_SPLIT, 0
    th = jl3d.pick_h_tile(s, h, w, extents, dh)
    if th is not None:
        return kl.BWD_TILED, th
    return kl.BWD_NONE, 0


def test_bwd_route_is_the_jax_packages():
    """The port's copy of ``_route_bwd`` against the JAX package's picks,
    over clips, grids, extents, head sizes and dtypes; every route
    occurs."""
    seen = set()
    for s in (1, 6, 32, 34):
        for h, w in ((2, 4), (8, 8), (16, 16), (32, 32), (64, 64)):
            for ext in ((3, 1, 1), (1, 2, 1), (1, 1, 1)):
                for dh in (32, 64, 128, 256):
                    for dtype, itemsize in ((torch.bfloat16, 2), (torch.float32, 4)):
                        want = _jax_route(s, h, w, ext, dh, itemsize)
                        got = kl.bwd_route((2, s, h, w, 2 * dh), 2, ext, dtype)
                        assert tuple(got) == want, (s, h, w, ext, dh, itemsize)
                        seen.add(want[0])
    assert seen == {kl.BWD_ALLFRAMES, kl.BWD_PER_FRAME, kl.BWD_SPLIT, kl.BWD_TILED,
                    kl.BWD_NONE}


@pytest.mark.parametrize("shape,heads,extents", [
    ((1, 6, 8, 8, 128), 1, (3, 1, 1)),
    ((1, 34, 2, 4, 64), 2, (1, 1, 1)),
], ids=["m3_allframes", "clip34_per_frame"])
def test_function_takes_the_rounded_plain_versions(shape, heads, extents):
    """The autograd Function on CPU bf16 tensors: its gradients are the
    plain versions' with ``bwd_route``'s partial rows, bit for bit, and
    so are the wrappers'."""
    ops, _ = _bf16_operands(shape, 11)
    leaves = [t.clone().requires_grad_() for t in ops[:3]]
    out = kl.local3d_attention(*leaves, extents, heads)
    got = torch.autograd.grad(out, leaves, ops[3])
    rows = kl.bwd_route(shape, heads, extents, torch.bfloat16).partial_rows
    want = _plain(ops, extents, heads, rows)
    assert rows == (2 if shape[1] > 32 else 0)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    dq, lse, delta = kl.local3d_bwd_dq(*ops, extents, heads)
    assert torch.equal(dq, want[0])
    for a, b in zip(kl.local3d_bwd_dkv(*ops, lse, delta, extents, heads), want[1:]):
        assert torch.equal(a, b)


def test_window_reaching_past_the_whole_clip_matches_jax():
    """A frame extent at least the clip's length (e_s = 3 over S = 2): the
    plain forward (JAX's XLA route) and the plain backward pair against
    JAX's, in f32 (the stacked key frames used to raise here)."""
    from world_modelz_tpu.models import attention as jattn

    rng = np.random.default_rng(4)
    shape, extents, heads = (1, 2, 4, 4, 16), (3, 1, 1), 2
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    want = jattn.local3d_attention(*(jnp.asarray(a) for a in (q, k, v)), extents, heads)
    np.testing.assert_allclose(pa.local3d_attention(tq, tk, tv, extents, heads).numpy(),
                               np.asarray(want), rtol=5e-4, atol=5e-5)
    _, vjp = jax.vjp(
        lambda q, k, v: jl3d.local3d_attention_pallas(q, k, v, extents, heads, True),
        *(jnp.asarray(a) for a in (q, k, v)))
    for got, ref in zip(_plain([tq, tk, tv, tg], extents, heads), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-5)
