"""Port parity: the port's input pipeline (``world_modelz_tpu_torch.data``)
and its CLI config helper against the JAX package's.

MovingMNIST clips are compared exactly: the port composites sprites with
the numpy path of the JAX package's compositor, the same float32 adds and
clamp, under the same per-index ``np.random.default_rng`` seeding.
"""

import dataclasses
import threading
import time
from typing import Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.data.moving_mnist import MovingMNIST as JaxMovingMNIST  # noqa: E402
from world_modelz_tpu.utils import config as jconfig  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.data import MovingMNIST, PrefetchIterator  # noqa: E402
from world_modelz_tpu_torch.utils import config as pconfig  # noqa: E402

# the trainer's clip (train_step/m3_b64_g8_full), a deterministic-bounce
# one, and a three-digit one on a smaller canvas
CONFIGS = [
    dict(seq_len=6, image_size=64, num_digits=2, digit_size=24, deterministic=False),
    dict(seq_len=20, image_size=64, num_digits=2, digit_size=24, deterministic=True),
    dict(seq_len=8, image_size=32, num_digits=3, digit_size=12, deterministic=False),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=["m3_clip", "bounce20", "three_digits"])
def test_moving_mnist_clips_equal_jax_clip_by_clip(kw):
    ours, theirs = MovingMNIST(**kw), JaxMovingMNIST(**kw)
    assert repr(ours) == repr(theirs) and len(ours) == len(theirs)
    np.testing.assert_array_equal(ours.bank, theirs.bank)
    for index in (0, 1, 7, 123, 59_999):
        got, want = ours[index], theirs[index]
        assert got.dtype == np.float32 and got.shape == (
            kw["seq_len"], kw["image_size"], kw["image_size"], 1)
        np.testing.assert_array_equal(got, want, err_msg=str(index))
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.max() > 0.5


def test_moving_mnist_batches_equal_jax_under_the_same_rng():
    kw = CONFIGS[0]
    ours, theirs = MovingMNIST(**kw), JaxMovingMNIST(**kw)
    a = ours.sample_batch_u8(np.random.default_rng(3), 5)
    b = theirs.sample_batch_u8(np.random.default_rng(3), 5)
    assert a.dtype == np.uint8 and a.shape == (5, 6, 64, 64, 1)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        ours.sample_batch(np.random.default_rng(4), 2),
        theirs.sample_batch(np.random.default_rng(4), 2))


def test_moving_mnist_reads_an_mnist_file(tmp_path):
    rng = np.random.default_rng(0)
    digits = rng.integers(0, 256, (4, 28, 28)).astype(np.uint8)
    np.savez(tmp_path / "mnist.npz", x_train=digits)
    kw = dict(CONFIGS[2], data_root=str(tmp_path))
    ours, theirs = MovingMNIST(**kw), JaxMovingMNIST(**kw)
    assert ours.bank.shape == (4, 12, 12)
    np.testing.assert_allclose(ours.bank, theirs.bank, rtol=0, atol=0)
    np.testing.assert_array_equal(ours[5], theirs[5])


def test_build_clip_fn_ships_uint8_clips_of_the_config():
    cfg = vd.VideoDiffusionConfig(batch_size=3, n_past=5)
    clip_fn, sampler = vd.build_clip_fn(cfg, 42)
    a = clip_fn(3)
    assert sampler is None and a.dtype == np.uint8 and a.shape == (3, 6, 64, 64, 1)
    ref = JaxMovingMNIST(seq_len=6, deterministic=False).sample_batch_u8(
        np.random.default_rng(42), 3)
    np.testing.assert_array_equal(a, ref)
    frames = vd.as_frames(torch.from_numpy(a), cfg.image_size)
    assert frames.dtype == torch.float32
    torch.testing.assert_close(frames, torch.from_numpy(a).float() / 255.0)


def test_prefetch_keeps_order_and_closes_cleanly():
    made = iter(range(1000))
    it = PrefetchIterator(lambda: np.full((2, 3), next(made), np.int64), depth=3,
                          device=torch.device("cpu"))
    got = [next(it) for _ in range(20)]
    assert all(isinstance(t, torch.Tensor) and t.shape == (2, 3) for t in got)
    assert [int(t[0, 0]) for t in got] == list(range(20))
    it.close()
    assert not it._thread.is_alive()


def test_prefetch_raises_the_producer_error_in_order():
    calls = []

    def make():
        calls.append(1)
        if len(calls) == 3:
            raise KeyError("boom")
        return np.ones(2, np.float32)

    it = PrefetchIterator(make, depth=1)
    assert np.array_equal(next(it), np.ones(2))
    next(it)
    with pytest.raises(KeyError, match="boom"):
        next(it)
    it.close()
    assert not it._thread.is_alive()


def test_prefetch_close_while_the_worker_is_blocked():
    """A full queue and a slow producer: close() still stops the worker."""
    release = threading.Event()

    def make():
        release.wait(0.05)
        return np.zeros(1)

    it = PrefetchIterator(make, depth=1)
    time.sleep(0.2)  # the queue is full; the worker waits to put
    t0 = time.perf_counter()
    it.close()
    assert not it._thread.is_alive() and time.perf_counter() - t0 < 5.0


@dataclasses.dataclass
class _Cfg:
    lr: float = 1e-3
    steps: int = 3
    name: str = "run"
    flag: bool = False
    extents: Tuple[int, int, int] = (3, 1, 1)


@pytest.mark.parametrize("argv", [
    [],
    ["--lr", "0.5", "--steps", "7", "--name", "x", "--flag", "yes", "--extents", "1,2,3"],
    ["--flag", "0", "--extents", "2,2,2"],
])
def test_dataclass_cli_parses_as_the_jax_helper(argv):
    ours = pconfig.dataclass_cli(_Cfg, argv)
    theirs = jconfig.dataclass_cli(_Cfg, argv)
    assert ours == theirs
    assert pconfig.config_to_dict(ours) == jconfig.config_to_dict(theirs)


def test_trainer_config_has_the_jax_fields_and_defaults():
    from world_modelz_tpu.cli.video_diffusion import VideoDiffusionConfig as Jax

    ours = pconfig.config_to_dict(vd.VideoDiffusionConfig())
    theirs = jconfig.config_to_dict(Jax())
    assert ours == theirs
