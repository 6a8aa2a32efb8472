"""Port parity: on-device MovingMNIST compositing
(``world_modelz_tpu_torch.data.device_composite``) and ``--device_composite``
in the denoiser trainer, against the JAX package.

``composite_clips`` is held to JAX's one-hot formulation within 1 f32 ulp
(measured: bitwise) for uint8 and float sprites with off-canvas positions;
``sample_batch_traj`` equals JAX's arrays; the composite trainer at k = 2
equals k = 1 bitwise and its checkpoint rolls out.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from world_modelz_tpu.data.device_composite import as_frames as jax_as_frames  # noqa: E402
from world_modelz_tpu.data.device_composite import (  # noqa: E402
    composite_clips as jax_composite_clips,
)
from world_modelz_tpu.data.moving_mnist import MovingMNIST as JaxMovingMNIST  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import rollout as ro  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.data import (  # noqa: E402
    MovingMNIST,
    PrefetchIterator,
    as_frames,
    batch_to,
    composite_clips,
)
from world_modelz_tpu_torch.models import VQAutoEncoder  # noqa: E402

KW = dict(seq_len=6, image_size=64, num_digits=2, digit_size=24, deterministic=False)


def _ulps(a, b):
    """The largest distance in f32 units in the last place."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ai, bi = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_composite_clips_equal_jax_with_off_canvas_positions(dtype):
    rng = np.random.default_rng(0)
    b, d, k, s, h = 3, 3, 10, 5, 28
    if dtype == "uint8":
        sprites = rng.integers(0, 256, (b, d, k, k)).astype(np.uint8)
    else:
        sprites = (rng.random((b, d, k, k), dtype=np.float32) * 0.6).astype(np.float32)
    # inside, overhanging every edge, and wholly off the canvas
    pos = rng.integers(-k - 3, h + 3, (b, d, s, 2)).astype(np.int32)
    pos[0, 0, 0] = (-k, -k)
    pos[0, 1, 1] = (h, h)
    want = np.asarray(jax_composite_clips(jnp.asarray(sprites), jnp.asarray(pos), h))
    got = composite_clips(torch.from_numpy(sprites), torch.from_numpy(pos), h)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, h, 1)
    assert _ulps(got.numpy(), want) <= 1
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


def test_sample_batch_traj_equals_jax_and_composites_the_host_clip():
    ours, theirs = MovingMNIST(**KW), JaxMovingMNIST(**KW)
    a = ours.sample_batch_traj(np.random.default_rng(5), 4)
    b = theirs.sample_batch_traj(np.random.default_rng(5), 4)
    assert a.keys() == b.keys() == {"sprites", "pos"}
    assert a["sprites"].dtype == np.uint8 and a["sprites"].shape == (4, 2, 24, 24)
    assert a["pos"].dtype == np.int32 and a["pos"].shape == (4, 2, 6, 2)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    # the same per-index stream as the pixel path: equal to the host clip
    # quantized to 1/255 where no two sprites overlap, within 2/255 where
    # they do
    frames = composite_clips(torch.from_numpy(a["sprites"]), torch.from_numpy(a["pos"]),
                             64).numpy()
    u8 = ours.sample_batch_u8(np.random.default_rng(5), 4)
    host = u8.astype(np.float32) / 255.0
    cover = np.zeros(frames.shape[:4], np.int32)
    for i in range(4):
        for j in range(2):
            for t in range(6):
                y, x = a["pos"][i, j, t]
                cover[i, t, max(y, 0): y + 24, max(x, 0): x + 24] += 1
    alone = cover <= 1
    np.testing.assert_array_equal(frames[..., 0][alone], host[..., 0][alone])
    assert float(np.abs(frames - host).max()) <= 2.0 / 255.0


def test_as_frames_takes_the_three_formats_as_jax():
    u8 = np.full((1, 2, 8, 8, 1), 128, np.uint8)
    np.testing.assert_array_equal(as_frames(u8, 8).numpy(), np.asarray(jax_as_frames(u8, 8)))
    assert as_frames(torch.from_numpy(u8), 8).dtype == torch.float32
    f32 = np.random.default_rng(0).random((1, 2, 8, 8, 1), np.float32)
    np.testing.assert_array_equal(as_frames(torch.from_numpy(f32), 8).numpy(), f32)
    # the step program's static inputs: pixels under "frames"
    for x in (u8, f32):
        np.testing.assert_array_equal(as_frames({"frames": torch.from_numpy(x)}, 8).numpy(),
                                      as_frames(torch.from_numpy(x), 8).numpy())
    traj = {"sprites": np.full((1, 1, 2, 2), 255, np.uint8),
            "pos": np.zeros((1, 1, 2, 2), np.int32)}
    out = as_frames(batch_to(traj, "cpu"), 8)
    want = np.asarray(jax_as_frames({k: jnp.asarray(v) for k, v in traj.items()}, 8))
    assert tuple(out.shape) == (1, 2, 8, 8, 1)
    np.testing.assert_array_equal(out.numpy(), want)
    assert out[0, 0, 0, 0, 0] == 1.0 and out[0, 0, 4, 4, 0] == 0.0


def test_prefetch_ships_dict_batches_and_the_consumed_state():
    made = iter(range(100))
    state = {"n": 0}

    def make():
        state["n"] = next(made)
        return {"sprites": np.full((2, 1, 3, 3), state["n"], np.uint8),
                "pos": np.full((2, 1, 4, 2), state["n"], np.int32)}

    it = PrefetchIterator(make, depth=3, device=torch.device("cpu"),
                          state_fn=lambda: state["n"], probe_every=1)
    assert it.consumed_state() == 0  # before the worker made any
    got = [next(it) for _ in range(4)]
    assert [int(g["pos"][0, 0, 0, 0]) for g in got] == [0, 1, 2, 3]
    assert all(isinstance(g["sprites"], torch.Tensor) for g in got)
    # the position of the batch taken, not of the ones prefetched ahead
    assert it.consumed_state() == 3
    stats = it.transfer_stats()
    assert stats["mb_per_batch"] == round((2 * 9 + 2 * 4 * 2 * 4) / 1e6, 3)
    it.close()


TOK_CFG = dict(embedding_dim=8, num_embeddings=16, downscale_steps=2, hidden_planes=8,
               in_channels=1)


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    torch.manual_seed(0)
    tok = VQAutoEncoder(**TOK_CFG, device="cpu")
    return ptrain.save_checkpoint(str(tmp_path_factory.mktemp("ctok")), 0,
                                  {"tokenizer": tok.state_dict()}, TOK_CFG)


def _cfg(tok_path, out, **kw):
    base = dict(platform="cpu", decoder_model=tok_path, output_dir=str(out),
                dataset="moving_mnist", device_composite=True, batch_size=2, n_past=2,
                image_size=16, digit_size=6, dim=32, depth=2, mlp_dim=24, dim_head=16,
                heads=2, extents=(1, 1, 1), warmup=2, max_steps=6, eval_interval=0,
                checkpoint_interval=6, log_interval=3, ema_decay=0.9, bf16=True)
    base.update(kw)
    return vd.VideoDiffusionConfig(**base)


def test_composite_trainer_k2_equals_k1_through_eval_checkpoint_and_rollout(tok_path, tmp_path):
    one = vd.train(_cfg(tok_path, tmp_path / "k1"))
    two = vd.train(_cfg(tok_path, tmp_path / "k2", steps_per_dispatch=2, eval_interval=6,
                        eval_timesteps=1, eval_batch_size=2, num_eval_iterations=2))
    assert [h[1:4] for h in one.history] == [h[1:4] for h in two.history]
    assert two.program.inputs.tensors.keys() == {"sprites", "pos"}
    assert [(e[0], e[1]) for e in two.evals] == [(6, "base"), (6, "ema")]
    a, _, _ = ptrain.restore_checkpoint(str(tmp_path / "k1" / "step_0000006"))
    b, _, cfg = ptrain.restore_checkpoint(str(tmp_path / "k2" / "step_0000006"))
    assert cfg["device_composite"] is True
    for part in ("params", "ema"):
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), (part, key)
    # the rollout CLI takes pixel clips from a composite run's checkpoint
    res = ro.run(ro.RolloutConfig(
        platform="cpu", checkpoint=str(tmp_path / "k2" / "step_0000006"), batch_size=2,
        num_frames=2, num_eval_iterations=2, gt_metrics=True,
        output_dir=str(tmp_path / "ro"), name="ro"))
    assert res.rollout.train_cfg.device_composite is False
    assert res.decoded.shape == (2, 2, 16, 16, 1) and np.isfinite(res.decoded).all()
    assert os.path.isfile(tmp_path / "ro" / "ro_gt_metrics.json")


@pytest.mark.parametrize("kw", [dict(data_pipeline="grain"), dict(dataset="synthetic")],
                         ids=lambda kw: next(iter(kw)))
def test_device_composite_needs_moving_mnist_on_the_native_pipeline(tok_path, tmp_path, kw):
    with pytest.raises(ValueError, match="device_composite"):
        vd.train(_cfg(tok_path, tmp_path, **kw))


def test_composite_step_equals_the_pixel_step_on_the_same_frames(tok_path):
    """One step on a trajectory batch and one on its frames composited on
    the host side give bitwise the same loss and state."""
    cfg = _cfg(tok_path, "unused")
    tok, _ = vd.load_tokenizer(tok_path, "cpu")
    vd.tokenizer_inference_cast(tok)
    traj = MovingMNIST(seq_len=3, image_size=16, num_digits=2, digit_size=6,
                       deterministic=False).sample_batch_traj(np.random.default_rng(2), 2)
    batch = batch_to(traj, "cpu")
    frames = composite_clips(batch["sprites"], batch["pos"], 16)
    shape = (3, *tok.token_grid_shape((16, 16)))
    rows, states = [], []
    for x in (batch, frames):
        torch.manual_seed(3)
        state = vd.init_state(cfg, vd.make_model(cfg, shape, 16, "cpu"))
        draws = vd.draw_step(torch.Generator().manual_seed(4), 2, shape[1] * shape[2], 100, 16)
        rows.append(vd.train_step(state, tok, x, dataclasses.replace(cfg), draws))
        states.append(state.model.state_dict())
    assert rows[0] == rows[1]
    for key in states[0]:
        assert torch.equal(states[0][key], states[1][key]), key
