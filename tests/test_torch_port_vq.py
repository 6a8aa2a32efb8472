"""Port parity: VQ lookups (``world_modelz_tpu_torch.ops.vq``) and the
nearest-code kernel wrapper against the JAX package.

Indices are compared on rows whose top-2 distance gap exceeds 1e-4: below
that, f32 rounding in a different summation order may flip a near-tie
(docs/PARITY.md, nearest-code tie-breaking). Everything runs in f32 on the
CPU, where the wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.kernels.vq_kernels import vq_encode_pallas  # noqa: E402
from world_modelz_tpu.ops import vq as jvq  # noqa: E402
from world_modelz_tpu_torch.kernels import vq_encode_nearest  # noqa: E402
from world_modelz_tpu_torch.ops import vq as tvq  # noqa: E402

TIE_GAP = 1e-4


def _state(codebook):
    L, K, _ = codebook.shape
    return jvq.VQState(
        codebook=jnp.asarray(codebook),
        cluster_size=jnp.ones((L, K)),
        activation_count=jnp.zeros((L, K)),
        accumulated_error=jnp.zeros((L, K)),
    )


def _untied_rows(codebook, x):
    """Rows (N,) whose two nearest codes differ by more than TIE_GAP."""
    d = ((x[:, None, :] - codebook[0][None]) ** 2).sum(-1).astype(np.float64)
    top2 = np.sort(d, axis=-1)[:, :2]
    return top2[:, 1] - top2[:, 0] > TIE_GAP


@pytest.mark.parametrize("n,k,d", [(100, 32, 16), (37, 16, 8), (256, 32, 32)])
def test_vq_encode_matches_jax(n, k, d):
    rng = np.random.default_rng(n)
    codebook = rng.normal(size=(1, k, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ref = np.asarray(jvq.vq_encode(_state(codebook), jnp.asarray(x)[:, None]))
    got = tvq.vq_encode(torch.from_numpy(codebook), torch.from_numpy(x)[:, None])
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    ok = _untied_rows(codebook, x)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[ok, 0], ref[ok, 0])


def test_vq_wrapper_matches_pallas_interpret():
    """The CPU wrapper (plain version) against the Pallas kernel run in
    interpret mode, index-only, as tests/test_kernels.py runs it."""
    rng = np.random.default_rng(1)
    codebook = rng.normal(size=(1, 32, 16)).astype(np.float32)
    x = rng.normal(size=(100, 16)).astype(np.float32)
    ref, q = vq_encode_pallas(
        jnp.asarray(x), jnp.asarray(codebook[0]), tile_n=32, interpret=True,
        return_quantized=False,
    )
    assert q is None
    got = vq_encode_nearest(torch.from_numpy(x), torch.from_numpy(codebook[0]))
    ok = _untied_rows(codebook, x)
    np.testing.assert_array_equal(got.numpy()[ok], np.asarray(ref)[ok])


def test_vq_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    codebook = torch.from_numpy(rng.normal(size=(24, 8)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    got = vq_encode_nearest(x, codebook)
    want = tvq.vq_encode(codebook[None], x[:, None]).reshape(-1)
    assert torch.equal(got, want)


def test_vq_encode_ties_go_to_lowest_index():
    codebook = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]]])
    x = torch.tensor([[0.5, 0.5], [1.0, 0.0]])
    assert tvq.vq_encode(codebook, x[:, None]).reshape(-1).tolist() == [0, 0]


def test_codebook_distances_match_jax():
    """f32 distances within 1e-4 absolute (values are O(10); the same
    identity summed in another order)."""
    rng = np.random.default_rng(3)
    codebook = rng.normal(size=(2, 16, 8)).astype(np.float32)
    x = rng.normal(size=(20, 2, 8)).astype(np.float32)
    ref = jvq.codebook_distances(jnp.asarray(codebook), jnp.asarray(x))
    got = tvq.codebook_distances(torch.from_numpy(codebook), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_vq_decode_matches_jax_and_clamps_mask_token():
    """Exact: decode is a gather. Index K (the mask token), 99 and -1 are
    read as JAX's take_along_axis(mode='clip') reads them."""
    rng = np.random.default_rng(4)
    codebook = rng.normal(size=(1, 16, 8)).astype(np.float32)
    idx = rng.integers(0, 16, size=(3, 4, 4)).astype(np.int32)
    idx[0, 0, 0] = 16  # mask token
    idx[1, 2, 3] = 99
    idx[2, 1, 1] = -1
    ref = jvq.vq_decode(_state(codebook), jnp.asarray(idx)[..., None])
    got = tvq.vq_decode(torch.from_numpy(codebook), torch.from_numpy(idx)[..., None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert np.isfinite(got.numpy()).all()


def test_vq_wrapper_rejects_bad_shapes():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        vq_encode_nearest(x, torch.zeros(16, 4))
    with pytest.raises(ValueError):
        vq_encode_nearest(x[None], torch.zeros(16, 8))
