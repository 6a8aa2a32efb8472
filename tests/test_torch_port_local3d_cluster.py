"""Port parity: the design of the f32 local-3D forward at head sizes 64 and
128 (csrc/local3d_fwd.cu:local3d_fwd_cluster_kernel), emulated on the CPU,
against the TPU forward ``local3d_attention_pallas`` in f32 in interpret
mode; and the products it executes, as chip_smoke.py logs them.

The kernel serves a query tile (64 positions of one frame) with a thread
block cluster of C CTAs: rank r takes the window's frames fa + r, fa + r +
C, ... inside the clip (ranks without a frame leave), stages each frame's
key band in 64-key steps. Each of a CTA's 32 groups of lanes serves two
neighbouring queries and walks the keys of the box that holds both
windows in a step, four at a time in row-major order, each query scoring
the keys of its own window, with one online softmax a query in f32
(running max m, sum l, acc rescaled as m moves); a warp's four groups walk
as many batches as the one with the most keys. Then the cluster merges
its CTAs' (m, l, acc) in rank order: w_j = exp(m_j - max m), l = sum l_j
w_j, out = (sum acc_j w_j) / l. The emulation here follows those steps
and counts the multiply-adds they take.

Tolerance, times max(1, max |x|): the kernel's design within 1e-5 of the
TPU forward in f32 (f32 sums in another order).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest

from world_modelz_tpu.kernels.local3d import local3d_attention_pallas

TOL = 1e-5
TILE_Q = 64  # query positions of a tile
STEP_KEYS = 64  # key positions of a staged step
BATCH = 4  # keys a query scores at once
GROUPS = TILE_Q // 2  # groups of lanes of a CTA, two queries each
WARP_GROUPS = 4  # groups of a warp


def key_band(p0: int, p1: int, h: int, w: int, eh: int):
    """Key positions [lo, hi) that query positions [p0, p1) can see in any
    frame (csrc/local3d_mma.cuh:key_band)."""
    return max(p0 // w - eh, 0) * w, (min((p1 - 1) // w + eh, h - 1) + 1) * w


def cluster_local3d(q, k, v, extents, heads, clusters):
    """The kernel's forward for (B, S, H, W, heads * dh) f32 numpy operands,
    with query tiles served by clusters of ``clusters`` CTAs, and the flops
    (2 a multiply-add) its walk takes."""
    b, s, h, w, inner = q.shape
    dh = inner // heads
    es, eh, ew = extents
    hw = h * w
    scale = np.float32(dh**-0.5)
    # (B heads, S, HW, dh)
    qh, kh, vh = (x.reshape(b, s, hw, heads, dh).transpose(0, 3, 1, 2, 4)
                  .reshape(b * heads, s, hw, dh) for x in (q, k, v))
    z = b * heads
    out = np.zeros_like(qh)
    walked = {}  # (frame s, tile, key frame, step) -> each group's keys
    for si in range(s):
        fa, fb = max(si - es, 0), min(si + es, s - 1)
        active = min(clusters, fb - fa + 1)
        for p0 in range(0, hw, TILE_Q):
            p1 = min(p0 + TILE_Q, hw)
            lo, hi = key_band(p0, p1, h, w, eh)
            for g in range(GROUPS):  # a pair of neighbouring queries
                pair = [min(p0 + 2 * g, p1 - 1), min(p0 + 2 * g + 1, p1 - 1)]
                hw_q = [divmod(p, w) for p in pair]
                rows = range(max(min(r for r, _ in hw_q) - eh, 0),
                             min(max(r for r, _ in hw_q) + eh, h - 1) + 1)
                cols = range(max(min(c for _, c in hw_q) - ew, 0),
                             min(max(c for _, c in hw_q) + ew, w - 1) + 1)
                box = [hk * w + wk for hk in rows for wk in cols]  # row-major
                parts = [[] for _ in pair]
                for rank in range(active):
                    m = [np.full((z, 1), -np.inf, np.float32) for _ in pair]
                    lsum = [np.zeros((z, 1), np.float32) for _ in pair]
                    acc = [np.zeros((z, dh), np.float32) for _ in pair]
                    for f in range(fa + rank, fb + 1, clusters):
                        for t0 in range(lo, hi, STEP_KEYS):
                            keys = [pk for pk in box if t0 <= pk < min(t0 + STEP_KEYS, hi)]
                            walked.setdefault((si, p0, f, t0), [0] * GROUPS)[g] = len(keys)
                            for i0 in range(0, len(keys), BATCH):
                                batch = keys[i0:i0 + BATCH]
                                kt, vt = kh[:, f, batch], vh[:, f, batch]
                                for j, (hq, wq) in enumerate(hw_q):
                                    inside = np.array([abs(pk // w - hq) <= eh and abs(pk % w - wq) <= ew
                                                       for pk in batch])
                                    qv = qh[:, si, pair[j]][:, None, :]
                                    sc = np.matmul(qv, np.swapaxes(kt, -1, -2))[:, 0] * scale
                                    sc = np.where(inside, sc, -np.inf).astype(np.float32)
                                    mb = np.maximum(m[j], sc.max(-1, keepdims=True))
                                    base = np.where(mb == -np.inf, 0, mb).astype(np.float32)
                                    corr = np.exp(m[j] - base)
                                    pexp = np.exp(sc - base)
                                    lsum[j] = lsum[j] * corr + pexp.sum(-1, keepdims=True, dtype=np.float32)
                                    acc[j] = acc[j] * corr + np.matmul(pexp[:, None, :], vt)[:, 0]
                                    m[j] = mb
                    for j in range(2):
                        parts[j].append((m[j], lsum[j], acc[j]))
                for j, p in enumerate(pair[:max(p1 - p0 - 2 * g, 0)]):
                    if active == 1:
                        _, lsum, acc = parts[j][0]
                        out[:, si, p] = acc * (np.float32(1) / lsum)
                        continue
                    mx = np.max([pm for pm, _, _ in parts[j]], axis=0)
                    lx = np.zeros_like(mx)
                    ax = np.zeros_like(parts[j][0][2])
                    for pm, pl, pa in parts[j]:  # rank order
                        wt = np.exp(pm - mx)
                        lx = lx + pl * wt
                        ax = ax + pa * wt
                    out[:, si, p] = ax * (np.float32(1) / lx)
    # both queries of a group score every key of its warp's batches (as
    # many as the warp's group with the most keys in the step needs) and
    # take P V over the group's own keys
    macs = 0
    for n in walked.values():
        for w0 in range(0, GROUPS, WARP_GROUPS):
            most = max(n[w0:w0 + WARP_GROUPS])
            macs += sum(-(-most // BATCH) * BATCH + x for x in n[w0:w0 + WARP_GROUPS])
    flops = 2 * macs * 2 * dh * z
    return out.reshape(b, heads, s, hw, dh).transpose(0, 2, 3, 1, 4).reshape(q.shape), flops


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    return q, k, v


def _tpu_f32(q, k, v, extents, heads):
    out = local3d_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   tuple(extents), heads, True)
    out = np.asarray(out)
    assert out.dtype == np.float32
    return out


def _rel_err(got, want):
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def test_key_bands_follow_the_kernel():
    assert key_band(0, 64, 8, 8, 1) == (0, 64)  # serving: the whole frame
    assert key_band(64, 128, 16, 16, 1) == (48, 144)  # 6 rows of 16: two steps
    assert key_band(32, 64, 64, 32, 1) == (0, 96)


@pytest.mark.parametrize("shape,heads,extents,clusters", [
    ((2, 6, 8, 8, 128), 1, (3, 1, 1), 1),
    ((2, 6, 8, 8, 128), 1, (3, 1, 1), 6),  # ranks 4, 5 of the first frame's tile leave
    ((2, 6, 8, 8, 128), 2, (1, 2, 1), 3),  # two heads of 64
    ((1, 12, 8, 8, 128), 1, (5, 1, 1), 8),  # 2 es + 1 > 8: ranks 0-2 take two frames
    ((1, 2, 16, 8, 64), 1, (1, 3, 1), 2),  # a band of two 64-key steps
])
def test_cluster_local3d_matches_the_tpu_forward(shape, heads, extents, clusters):
    q, k, v = _operands(shape, sum(shape) + clusters)
    want = _tpu_f32(q, k, v, extents, heads)
    got, _ = cluster_local3d(q, k, v, extents, heads, clusters)
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("shape,heads,extents", [
    ((1, 6, 8, 8, 64), 1, (3, 1, 1)),  # the rollout's window: 12-key boxes
    ((1, 2, 16, 8, 64), 1, (1, 3, 1)),  # boxes split across two steps
    ((1, 3, 6, 6, 64), 1, (1, 1, 1)),  # a 36-query tile: 14 groups past it
])
def test_cluster_walk_executes_what_chip_smoke_logs(shape, heads, extents):
    """The emulated walk matches the TPU forward, and the multiply-adds it
    takes are what chip_smoke.py logs as the kernel's executed products,
    more than the window's (4 dh per valid pair)."""
    q, k, v = _operands(shape, sum(shape))
    got, flops = cluster_local3d(q, k, v, extents, heads, 2)
    assert _rel_err(got, _tpu_f32(q, k, v, extents, heads)) <= TOL
    b, s, h, w, inner = shape
    cs = _chip_smoke()
    assert flops == cs.local3d_cluster_executed_ops(b, s, h, w, heads, inner // heads,
                                                    extents, STEP_KEYS)
    assert flops > 4 * inner * b * cs.window_pairs(s, h, w, extents)
