"""Port parity: the frame tokenizer (``world_modelz_tpu_torch.models``)
against the JAX ``VQAutoEncoder`` on the same weights, carried across by
``world_modelz_tpu_torch.convert``.

Small f32 tokenizer on the CPU (16x16x1 frames, 2 downscale steps, width 8,
K=16). Tokens must be equal wherever the two nearest codes of the JAX
latent differ by more than 1e-4 (the tie rule of docs/PARITY.md); pixels
and latents agree within 1e-4 (f32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.models.conv import upsample_2x as jax_upsample  # noqa: E402
from world_modelz_tpu.models.tokenizer import (  # noqa: E402
    tokenizer_inference_cast as jax_cast,
)
from world_modelz_tpu.utils import torch_export  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.models import (  # noqa: E402
    VQAutoEncoder,
    tokenizer_inference_cast,
)
from world_modelz_tpu_torch.models.conv import upsample_2x  # noqa: E402

IMG, C, D, K, L, HID = 16, 1, 8, 16, 2, 8
TOL = 1e-4
TIE_GAP = 1e-4


def _perturb(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.normal(size=a.shape).astype(np.float32),
        tree,
    )


@pytest.fixture(scope="module")
def pair():
    """(JAX tokenizer, its state with non-trivial BN stats, the port)."""
    rng = np.random.default_rng(0)
    jtok = JaxTokenizer(
        embedding_dim=D, num_embeddings=K, downscale_steps=L,
        hidden_planes=HID, in_channels=C,
    )
    state = jtok.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, C)))
    params = _perturb(state.params, rng, 0.1)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, size=a.shape)
                   if a.ndim == 1 else a).astype(np.float32),
        stats,
    )
    # means drawn separately so they stay signed
    for path in _bn_paths(stats):
        path["mean"] = (0.1 * rng.normal(size=path["mean"].shape)).astype(np.float32)
    state = state.replace(params=params, batch_stats=stats)
    codebook = np.asarray(state.vq.codebook)
    ptok = VQAutoEncoder(D, K, L, HID, C, device="cpu")
    ptok.load_state_dict(
        convert.tokenizer_state_dict_from_state(params, stats, codebook),
        strict=True,
    )
    return jtok, state, ptok


def _bn_paths(tree):
    if isinstance(tree, dict) or hasattr(tree, "keys"):
        if "mean" in tree and "var" in tree:
            yield tree
        else:
            for v in tree.values():
                yield from _bn_paths(v)


def _images(seed, n=6):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, IMG, IMG, C)).astype(np.float32)


def _untied(latent, codebook):
    d = ((latent[..., None, :] - codebook[0]) ** 2).sum(-1).astype(np.float64)
    top2 = np.sort(d, axis=-1)[..., :2]
    return top2[..., 1] - top2[..., 0] > TIE_GAP


def test_convert_tokenizer_matches_torch_export(pair):
    """The port's bridge writes exactly the keys and values of the JAX
    package's reference exporter (plus nothing else)."""
    _, state, _ = pair
    ref = torch_export.tokenizer_state_dict_from_state(state)
    got = convert.tokenizer_state_dict_from_state(
        state.params, state.batch_stats, np.asarray(state.vq.codebook),
        cluster_size=np.asarray(state.vq.cluster_size),
    )
    assert sorted(got) == sorted(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)


def test_encoder_latents_match_jax(pair):
    jtok, state, ptok = pair
    x = _images(1)
    ref = np.asarray(jtok.encode_continuous(state, jnp.asarray(x)))
    with torch.no_grad():
        got = ptok.encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=TOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_encode_tokens_match_jax(pair, seed):
    jtok, state, ptok = pair
    x = _images(seed)
    ref = np.asarray(jtok.encode(state, jnp.asarray(x)))
    got = ptok.encode(torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape == (6, 4, 4)
    latent = np.asarray(jtok.encode_continuous(state, jnp.asarray(x)))
    ok = _untied(latent, np.asarray(state.vq.codebook))
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[ok], ref[ok])


def test_decode_pixels_match_jax_incl_mask_token(pair):
    jtok, state, ptok = pair
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, K + 1, size=(5, 4, 4)).astype(np.int32)
    tokens[0, 0, 0] = K  # the mask token is clamped, never NaN
    ref = np.asarray(jtok.decode(state, jnp.asarray(tokens)))
    got = ptok.decode(torch.from_numpy(tokens))
    assert tuple(got.shape) == ref.shape == (5, IMG, IMG, C)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL)


def test_inference_cast_matches_jax(pair):
    """bf16-rounded conv weights and BN stats, f32 codebook, f32 images:
    the port rounds the same values the JAX cast stores."""
    jtok, state, original = pair
    ptok = VQAutoEncoder(D, K, L, HID, C, device="cpu")
    ptok.load_state_dict(original.state_dict())
    tokenizer_inference_cast(ptok)
    cast = jax_cast(state)
    ref_sd = torch_export.tokenizer_state_dict_from_state(
        cast.replace(
            params=jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), cast.params),
            batch_stats=jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), cast.batch_stats),
        )
    )
    got_sd = ptok.state_dict()
    for key, val in ref_sd.items():
        np.testing.assert_array_equal(got_sd[key].numpy(), val, err_msg=key)
    assert ptok.vq.embedding.dtype == torch.float32


def test_upsample_matches_jax_resize():
    """Bilinear 2x, half-pixel centres, clamped edges: within 1e-6."""
    x = np.random.default_rng(5).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jax_upsample(jnp.asarray(x)))
    got = upsample_2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_tokenizer_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VQAutoEncoder(D, K, L, HID, C)
