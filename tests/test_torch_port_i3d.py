"""Port parity: the I3D FVD extractor (``world_modelz_tpu_torch.utils.fvd``:
``I3D``, ``load_i3d``, ``i3d_features``, ``make_extractor("i3d")``)
against the Flax I3D of the JAX package (``utils/fvd.py:192-356``).

The weights are ``i3d_init``'s (flax's initializers depend only on the key
and the shapes, so the init runs jitted on a small clip; the Flax I3D
runs jitted too), with the
BatchNorm statistics, scales and offsets perturbed from a numpy seed, and
reach both packages through one ``.npz`` in the JAX layout. Tolerances:
features 1e-5 x max(1, max |f|) (f32 convolutions summed in another order:
measured 3e-7 of 0.4); the resize 1e-5 (bilinear at half-pixel centres,
antialiased when shrinking, as ``jax.image.resize(..., "linear")``:
measured 1.2e-7 enlarging, 2.4e-7 shrinking).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.utils import fvd as jfvd  # noqa: E402
from world_modelz_tpu_torch.utils import fvd as pfvd  # noqa: E402

FEAT_TOL = 1e-5
RESIZE_TOL = 1e-5


def _flat(variables):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(variables)[0]}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    model = jfvd.I3D()
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, 3)))
    rng = np.random.default_rng(0)
    arrays = {}
    for key, a in _flat(variables).items():
        if key.endswith("bn/mean") or key.endswith("bn/bias"):
            a = rng.normal(0.0, 0.1, a.shape)
        elif key.endswith("bn/var") or key.endswith("bn/scale"):
            a = rng.uniform(0.5, 1.5, a.shape)
        arrays[key] = np.asarray(a, np.float32)
    path = str(tmp_path_factory.mktemp("i3d") / "i3d.npz")
    np.savez(path, **arrays)
    jmodel, jvars = jfvd.load_i3d(path)
    return path, arrays, jmodel, jvars, pfvd.load_i3d(path, "cpu")


def test_param_paths_equal_jax():
    _, abstract = jfvd.i3d_abstract()
    assert pfvd.i3d_param_paths() == list(jfvd.i3d_param_paths(abstract))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FEAT_TOL * max(1.0, float(np.abs(want).max())))


def test_module_matches_flax(weights):
    _, _, jmodel, jvars, pmodel = weights
    x = np.random.default_rng(1).uniform(-1, 1, size=(1, 8, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(jvars, jnp.asarray(x)))
    with torch.no_grad(), pfvd.tf32_off():
        got = pmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 400)
    _close(got, want)


def test_features_of_a_one_channel_clip_match_jax(weights, monkeypatch):
    """i3d_features: one channel repeated, the 64 -> 224 resize, [-1, 1];
    and the extractor from WMZ_I3D_WEIGHTS."""
    path, _, jmodel, jvars, pmodel = weights
    clip = np.random.default_rng(2).uniform(size=(1, 8, 64, 64, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, c: jfvd.i3d_features(jmodel, v, c))(
        jvars, jnp.asarray(clip)))
    got = pfvd.i3d_features(pmodel, torch.from_numpy(clip)).numpy()
    _close(got, want)
    monkeypatch.setenv("WMZ_I3D_WEIGHTS", path)
    ex = pfvd.make_extractor("i3d", device="cpu")
    np.testing.assert_array_equal(pfvd.extract_features(ex, clip), got)


@pytest.mark.parametrize("size", [64, 256])
def test_resize_matches_jax(size):
    x = np.random.default_rng(size).uniform(size=(1, 2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, 224, 224, 3), "linear"))
    got = pfvd.resize_224(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_load_i3d_raises_as_jax(weights, tmp_path, fault):
    _, arrays, _, _, _ = weights
    broken = dict(arrays)
    key = "params/Mixed_4c/b1b/conv/kernel"
    if fault == "missing":
        del broken[key]
        match = "missing 1 arrays"
    else:
        broken[key] = broken[key][..., :-1]
        match = "Mixed_4c/b1b/conv/kernel: shape"
    path = str(tmp_path / "bad.npz")
    np.savez(path, **broken)
    for load in (jfvd.load_i3d, lambda p: pfvd.load_i3d(p, "cpu")):
        with pytest.raises(ValueError, match=match):
            load(path)


def test_save_i3d_round_trips(weights, tmp_path):
    _, arrays, _, _, pmodel = weights
    path = str(tmp_path / "again.npz")
    pfvd.save_i3d(pmodel, path)
    with np.load(path) as npz:
        assert sorted(npz.files) == sorted(arrays)
        for k in arrays:
            np.testing.assert_array_equal(npz[k], arrays[k])
