"""Port parity: the split-TF32 design of the VQ nearest-code search
(csrc/vq_search.cuh, shared by vq_encode.cu and vq_train.cu), emulated on
the CPU, against the TPU kernels (``vq_encode_pallas`` index-only and
``vq_train_stats_pallas``, in interpret mode).

The search takes x.e on the tensor cores in TF32, which keeps 10 mantissa
bits. Each operand v is split into hi = tf32(v) and lo = tf32(v - hi),
rounded as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero),
and each 8-deep step of x.e is taken as lo_x hi_e + hi_x lo_e + hi_x hi_e
into zeroed registers (one f32 rounding per product), then added to the
dot product in f32 in step order; the distance is |e|^2 - 2 x.e with the
prep kernel's f32 |e|^2 (lane partial sums, then a shuffle tree). A row's
minimum is the first one over codes visited in increasing order, and the
candidates of the code splits are merged by (distance, code).

Gates, as chip_smoke.py holds the card: at least 99.9% of rows agree with
the TPU kernels and every row whose float64 top-2 gap exceeds VQ_GAP
agrees. Why three products, through the distance error against float64:
the split emulation stays within VQ_GAP / 20, the one-product form (hi_x
hi_e) exceeds VQ_GAP, so it could flip rows the gate calls untied.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from world_modelz_tpu.kernels.vq_kernels import vq_encode_pallas, vq_train_stats_pallas

VQ_GAP = 1e-3  # chip_smoke.py VQ_GAP
SHARE = 0.999  # chip_smoke.py: the share of rows that must agree
SPLIT_TOL = VQ_GAP / 20
K, D = 512, 64
STEP = 8  # depth of a tensor-core product
LANES = 32


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on the int32 view: the magnitude rounded to 10
    mantissa bits, ties away from zero, the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32(x - hi)


def e_sq_f32(codebook: np.ndarray) -> np.ndarray:
    """|e_k|^2 as the prep kernel takes it: lane l of a warp sums d = l, l +
    32 by fmaf, then the lanes' sums meet in a shuffle tree."""
    e = codebook.astype(np.float64)
    lanes = np.zeros((codebook.shape[0], LANES), np.float32)
    for d in range(0, D, LANES):
        part = e[:, d:d + LANES]
        lanes = (part * part + lanes.astype(np.float64)).astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(LANES) ^ off]
    return lanes[:, 0]


def split_tf32_dot(x: np.ndarray, codebook: np.ndarray, products: int = 3) -> np.ndarray:
    """x e^T (N, K) in f32 as the search takes it: per 8-deep step, the
    step's TF32 products (small terms first) into zeroed registers, each
    product exact and rounded once to f32 as it is added, then the step's
    sum added to the dot product in f32. products: 3 (lo_x hi_e, hi_x lo_e,
    hi_x hi_e), 2 (a bf16 x: lo_x hi_e dropped) or 1 (hi_x hi_e)."""
    s = np.zeros((x.shape[0], codebook.shape[0]), np.float32)
    for k0 in range(0, D, STEP):
        (xh, xl), (eh, el) = split(x[:, k0:k0 + STEP]), split(codebook[:, k0:k0 + STEP])
        terms = {3: [(xl, eh), (xh, el), (xh, eh)], 2: [(xh, el), (xh, eh)],
                 1: [(xh, eh)]}[products]
        t = np.zeros_like(s)
        for a, b in terms:
            t = (t.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64).T
                 ).astype(np.float32)
        s = s + t
    return s


def split_tf32_distances(x, codebook, products=3):
    return e_sq_f32(codebook)[None, :] - np.float32(2) * split_tf32_dot(x, codebook, products)


def merge_min(cands):
    """The candidates (distance, code) of the code splits, in split order,
    merged by (distance, code): a tie goes to the lower code."""
    best_d, best_k = cands[0]
    for d, k in cands[1:]:
        take = (d < best_d) | ((d == best_d) & (k < best_k))
        best_d, best_k = np.where(take, d, best_d), np.where(take, k, best_k)
    return best_k


def search(dist, splits=4):
    """The kernel's selection over its distances: each split's first
    minimum over its codes in increasing order, merged in split order."""
    per = dist.shape[1] // splits
    cands = []
    for p in range(splits):
        part = dist[:, p * per:(p + 1) * per]
        k = part.argmin(1)
        cands.append((part[np.arange(len(dist)), k], k + p * per))
    return merge_min(cands)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to the nearest bf16 (ties to even), as f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return ((bits + bias) & np.uint32(0xFFFF0000)).view(np.float32)


@pytest.fixture(scope="module", params=[3072, 6144 + 37], ids=["n3072", "n6181_ragged"])
def case(request):
    n = request.param
    rng = np.random.default_rng(n)
    codebook = rng.normal(size=(K, D)).astype(np.float32)
    x = rng.normal(size=(n, D)).astype(np.float32)
    e64, x64 = codebook.astype(np.float64), x.astype(np.float64)
    dist64 = (e64 * e64).sum(-1)[None, :] - 2.0 * x64 @ e64.T
    return x, codebook, dist64


def _gate(got, want, dist64):
    top2 = np.sort(dist64, axis=1)[:, :2]
    untied = top2[:, 1] - top2[:, 0] > VQ_GAP
    agree = got == want
    return float(agree.mean()), int((~agree & untied).sum())


def test_split_tf32_search_passes_the_card_gate_against_the_tpu_kernels(case):
    x, codebook, dist64 = case
    got = search(split_tf32_distances(x, codebook))
    enc = np.asarray(vq_encode_pallas(jnp.asarray(x), jnp.asarray(codebook), interpret=True,
                                      return_quantized=False)[0])
    train = np.asarray(vq_train_stats_pallas(jnp.asarray(x), jnp.asarray(codebook),
                                             interpret=True)[0])
    for name, want in (("vq_encode_pallas", enc), ("vq_train_stats_pallas", train)):
        share, flipped = _gate(got, want, dist64)
        assert share >= SHARE and flipped == 0, (name, share, flipped)


def test_three_products_keep_the_distance_error_within_the_gate(case):
    """The distance error against float64 over every (row, code): three
    TF32 products stay within VQ_GAP / 20; one (hi_x hi_e) exceeds VQ_GAP,
    so it could move rows whose two nearest codes differ by more than the
    gate's gap."""
    x, codebook, dist64 = case
    err3 = float(np.abs(split_tf32_distances(x, codebook).astype(np.float64) - dist64).max())
    err1 = float(np.abs(split_tf32_distances(x, codebook, 1).astype(np.float64) - dist64).max())
    assert err3 <= SPLIT_TOL, err3
    assert err1 > VQ_GAP, err1


def test_bf16_x_drops_the_lo_product_bitwise():
    """A bf16 x is exact in TF32: its lo plane is zero, and the distances
    without the lo_x hi_e product are bitwise those with it."""
    rng = np.random.default_rng(3)
    codebook = rng.normal(size=(K, D)).astype(np.float32)
    x = to_bf16(rng.normal(size=(300, D)).astype(np.float32))
    assert not split(x)[1].any()
    three = split_tf32_distances(x, codebook, 3)
    two = split_tf32_distances(x, codebook, 2)
    np.testing.assert_array_equal(three.view(np.uint32), two.view(np.uint32))


def test_a_tie_goes_to_the_lower_code():
    """Equal codes in different splits and in one split: every row that
    sits on a duplicated code takes the lower of the two, as argmin does."""
    rng = np.random.default_rng(4)
    codebook = rng.normal(size=(K, D)).astype(np.float32)
    pairs = [(7, 300), (12, 13), (128, 511), (200, 201)]
    for lo, hi in pairs:
        codebook[hi] = codebook[lo]
    x = np.stack([codebook[hi] for _, hi in pairs] + [codebook[lo] for lo, _ in pairs])
    got = search(split_tf32_distances(x, codebook))
    want = [lo for lo, _ in pairs] * 2
    np.testing.assert_array_equal(got, want)
    enc = np.asarray(vq_encode_pallas(jnp.asarray(x), jnp.asarray(codebook), interpret=True,
                                      return_quantized=False)[0])
    np.testing.assert_array_equal(enc, want)
