"""Port parity: the host compositor (``world_modelz_tpu_torch.data.native``,
the port's own ``_native/compositor.cpp`` built with g++ into
``build/native/``) against the JAX package's numpy path and the port's own,
bitwise, and the sources that run it (MovingMNIST clips, synthetic
trajectory frames) against JAX's on both of the port's paths."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.data import native as jax_native  # noqa: E402
from world_modelz_tpu.data.moving_mnist import MovingMNIST as JaxMovingMNIST  # noqa: E402
from world_modelz_tpu.data.trajectory import (  # noqa: E402
    SyntheticTrajectorySource as JaxSynthetic,
)
from world_modelz_tpu_torch.data import (  # noqa: E402
    MovingMNIST,
    SyntheticTrajectorySource,
    native,
)


@pytest.fixture
def numpy_path(monkeypatch):
    """The port's entry points on their numpy path, as the environment
    variable selects it; the compiled path chosen again afterwards."""
    monkeypatch.setenv("WMZ_DISABLE_NATIVE", "1")
    assert native.reload() == "numpy"
    yield
    monkeypatch.delenv("WMZ_DISABLE_NATIVE")
    native.reload()


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """The JAX package's entry points on their numpy path."""
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    t, h, w, k = 7, 20, 24, 9
    frames = rng.random((t, h, w), dtype=np.float32) * 0.8
    sprite = rng.random((k, k), dtype=np.float32)
    # in-canvas, overhanging each edge, and wholly off the canvas
    pos = np.array([[3, 4], [-4, -2], [15, 20], [-9, 5], [19, 23], [0, -9], [11, 0]],
                   np.int32)
    bg = rng.uniform(-30, 290, (h, 2 * w, 3)).astype(np.float32)
    shifts = np.array([0, 3, w - 1, w, w + 5, 7, 2 * w - 1], np.int32)
    rects = np.stack([np.concatenate([rng.integers(-5, 22, (4, 2)), rng.integers(2, 12, (4, 1)),
                                      rng.uniform(0, 255, (4, 3))], 1)
                      for _ in range(t)]).astype(np.float32)
    return frames, sprite, pos, bg, shifts, rects


def _run(mod, frames, sprite, pos, bg, shifts, rects):
    f = frames.copy()
    mod.composite_sprite(f, sprite, pos)
    f2 = f * 1.7 - 0.2
    mod.clamp01(f2)
    out = np.zeros((len(shifts), frames.shape[1], frames.shape[2], 3), np.uint8)
    mod.render_trajectory(out, bg, shifts, rects)
    return {"composite_sprite": f, "clamp01": f2, "render_trajectory": out}


@pytest.fixture(scope="module")
def compiled():
    assert native.reload() == "compiled", native.failure()
    return _run(native, *_inputs(0))


@pytest.mark.parametrize("name", ["composite_sprite", "clamp01", "render_trajectory"])
def test_compiled_entry_points_equal_both_numpy_paths(compiled, numpy_path, jax_numpy_path,
                                                      name):
    ours = _run(native, *_inputs(0))[name]
    theirs = _run(jax_native, *_inputs(0))[name]
    assert compiled[name].dtype == theirs.dtype
    np.testing.assert_array_equal(compiled[name], theirs)
    np.testing.assert_array_equal(ours, theirs)


def test_the_library_is_built_under_build_named_by_its_digest():
    assert native.reload() == "compiled" and native.failure() is None
    path = native._library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("build", "native"))
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(native._SRC)))


def test_backend_reports_numpy_when_disabled(numpy_path):
    assert native.backend() == "numpy" and native.get_lib() is None
    assert "WMZ_DISABLE_NATIVE" in native.failure()


KW = dict(seq_len=6, image_size=64, num_digits=2, digit_size=24, deterministic=False)


@pytest.mark.parametrize("path", ["compiled", "numpy"])
def test_moving_mnist_and_synthetic_frames_equal_jax_on_each_path(request, path):
    if path == "numpy":
        request.getfixturevalue("numpy_path")
    else:
        assert native.reload() == "compiled"
    ours, theirs = MovingMNIST(**KW), JaxMovingMNIST(**KW)
    for index in (0, 5, 999):
        np.testing.assert_array_equal(ours[index], theirs[index])
    np.testing.assert_array_equal(ours.sample_batch_u8(np.random.default_rng(1), 3),
                                  theirs.sample_batch_u8(np.random.default_rng(1), 3))
    src = SyntheticTrajectorySource(num_trajectories=2, traj_frames=12, frame_size=24, seed=3)
    jsrc = JaxSynthetic(num_trajectories=2, traj_frames=12, frame_size=24, seed=3)
    np.testing.assert_array_equal(np.stack(list(src.load_frames("synthetic-0001"))),
                                  np.stack(list(jsrc.load_frames("synthetic-0001"))))
