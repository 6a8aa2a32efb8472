"""Port parity: the Grain pipeline (``world_modelz_tpu_torch.data.
grain_pipeline``) against the JAX package's, and the three trainers'
``--data_pipeline grain`` runs: each checkpoint keeps ``grain_state.json``,
the consumed position, equal to JAX's pipeline after the same records, and
a resume continues from it (the states compared as Grain's bytes)."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("grain")

from world_modelz_tpu.data.grain_pipeline import GrainClipPipeline as JaxPipeline  # noqa: E402
from world_modelz_tpu.data.moving_mnist import MovingMNIST as JaxMovingMNIST  # noqa: E402
from world_modelz_tpu.data.trajectory import (  # noqa: E402
    SyntheticTrajectorySource as JaxSynthetic,
)
from world_modelz_tpu.data.trajectory import (  # noqa: E402
    TrajectoryClipDataset as JaxClipDataset,
)
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.cli import train_vqae as tv  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.data import (  # noqa: E402
    MovingMNIST,
    SyntheticTrajectorySource,
    TrajectoryClipDataset,
)
from world_modelz_tpu_torch.data.grain_pipeline import GrainClipPipeline  # noqa: E402
from world_modelz_tpu_torch.models import VQAutoEncoder  # noqa: E402


def test_stream_equals_jax_and_its_state_round_trips():
    kw = dict(seq_len=3, image_size=32, num_digits=1, length=64)
    ours = GrainClipPipeline(MovingMNIST(**kw), 4, seed=7)
    theirs = JaxPipeline(JaxMovingMNIST(**kw), 4, seed=7)
    for n in (4, 2, 4):  # training and evaluation batch sizes from one stream
        a, b = ours.sample_batch(n), theirs.sample_batch(n)
        assert a.shape == (n, 3, 32, 32, 1)
        np.testing.assert_array_equal(a, b)
    state = ours.get_state()
    assert state == theirs.get_state()
    first = next(ours)
    ours.set_state(state)
    np.testing.assert_array_equal(ours.sample_batch(), first)
    other = GrainClipPipeline(MovingMNIST(**kw), 4, seed=8)
    assert not np.array_equal(other.sample_batch(), first)
    ours.close()


def test_shards_are_disjoint_and_cover_the_records():
    class Ints:
        def __len__(self):
            return 32

        def __getitem__(self, i):
            return np.asarray([i], np.int64)

    seen = []
    for index in (0, 1):
        pipe = GrainClipPipeline(Ints(), 8, seed=3, shuffle=False, shard_index=index,
                                 shard_count=2, num_epochs=1)
        jpipe = JaxPipeline(Ints(), 8, seed=3, shuffle=False, shard_index=index,
                            shard_count=2, num_epochs=1)
        got = pipe.sample_batch(16)
        np.testing.assert_array_equal(got, jpipe.sample_batch(16))
        seen.append(set(got[:, 0].tolist()))
    assert seen[0].isdisjoint(seen[1]) and len(seen[0] | seen[1]) == 32


def _position(state: bytes, same_source: bool) -> dict:
    """A Grain state, without the data source's repr unless the two
    packages' sources print the same (JAX's file list prints its address)."""
    d = json.loads(state)
    if not same_source:
        assert " at 0x" not in d.pop("data_source")
    return d


def _grain_state(path, same_source=True):
    with open(os.path.join(path, "grain_state.json"), "rb") as f:
        return _position(f.read(), same_source)


def _jax_position(pipe, batches, same_source=True):
    """JAX's pipeline state after drawing ``batches`` (sizes)."""
    for n in batches:
        pipe.sample_batch(n)
    state = json.loads(pipe.get_state())
    if not same_source:
        state.pop("data_source")
    return state


@pytest.mark.parametrize("dataset", ["moving_mnist", "files"])
def test_tokenizer_trainer_keeps_and_resumes_jax_record_position(tmp_path, dataset):
    from PIL import Image

    from world_modelz_tpu.data.images import FileListImageDataset as JaxFiles

    kw = dict(platform="cpu", dataset=dataset, data_pipeline="grain", batch_size=2,
              max_steps=4, downscale_steps=2, embedding_dim=8, hidden_planes=8,
              num_embeddings=16, checkpoint_interval=2, vq_reuse_interval=0,
              log_interval=2, output_dir=str(tmp_path / "run"), name="tg")
    if dataset == "moving_mnist":
        cfg = tv.TrainVqaeConfig(**kw, in_channels=1, image_size=32)
        jds = JaxMovingMNIST(seq_len=1, image_size=32, digit_size=24, num_digits=2)
    else:
        (tmp_path / "img").mkdir()
        for i in range(9):
            Image.fromarray(np.random.default_rng(i).integers(0, 256, (16, 16, 3)).astype(
                np.uint8)).save(tmp_path / "img" / f"{i}.png")
        cfg = tv.TrainVqaeConfig(**kw, in_channels=3, image_size=16,
                                 file_list_fn=str(tmp_path / "list.json"),
                                 image_dir_path=str(tmp_path / "img" / "*"))
    tv.train(cfg)
    if dataset == "files":
        from world_modelz_tpu_torch.data import load_file_list

        jds = JaxFiles(load_file_list(cfg.file_list_fn, "unused"), 2, seed=0)
    ckpt = str(tmp_path / "run" / "step_0000002")
    jpipe = JaxPipeline(jds, 2, seed=0)
    same = dataset == "moving_mnist"
    assert _grain_state(ckpt, same) == _jax_position(jpipe, [2, 2], same)
    assert _grain_state(str(tmp_path / "run" / "step_0000004"), same) == _jax_position(
        jpipe, [2, 2], same)
    # a resume in another process: the source's repr must not name an address
    resumed = tv.train(dataclasses.replace(cfg, checkpoint=ckpt, max_steps=6))
    assert resumed.state.step == 6
    assert _grain_state(str(tmp_path / "run" / "step_0000006"), same) == _jax_position(
        jpipe, [2, 2], same)


TOK = {1: dict(embedding_dim=8, num_embeddings=16, downscale_steps=2, hidden_planes=8,
               in_channels=1)}
TOK[3] = dict(TOK[1], in_channels=3)


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    out = {}
    for c, cfg in TOK.items():
        torch.manual_seed(0)
        tok = VQAutoEncoder(**cfg, device="cpu")
        out[c] = ptrain.save_checkpoint(str(tmp_path_factory.mktemp(f"gtok{c}")), 0,
                                        {"tokenizer": tok.state_dict()}, cfg)
    return out


@pytest.mark.parametrize("dataset", ["moving_mnist", "synthetic"])
def test_denoiser_keeps_and_resumes_jax_record_position(toks, tmp_path, dataset):
    c = 1 if dataset == "moving_mnist" else 3
    cfg = vd.VideoDiffusionConfig(
        platform="cpu", decoder_model=toks[c], dataset=dataset, data_pipeline="grain",
        output_dir=str(tmp_path), batch_size=2, n_past=2, image_size=16, digit_size=6,
        dim=32, depth=1, mlp_dim=24, dim_head=16, heads=2, extents=(1, 1, 1), warmup=2,
        max_steps=4, eval_interval=4, eval_timesteps=1, eval_batch_size=2,
        num_eval_iterations=2, checkpoint_interval=2, log_interval=2, skip_frames=1)
    result = vd.train(cfg)
    assert [e[1] for e in result.evals] == ["base"]
    if dataset == "moving_mnist":
        jds = JaxMovingMNIST(seq_len=3, image_size=16, num_digits=2, digit_size=6,
                             deterministic=False)
    else:
        jds = JaxClipDataset(JaxSynthetic(frame_size=16), traj_len=3, skip_frames=1,
                             seed=cfg.manual_seed)
    jpipe = JaxPipeline(jds, 2, seed=cfg.manual_seed)
    # the token-grid probe draws one record before the loop
    assert _grain_state(str(tmp_path / "step_0000002")) == _jax_position(jpipe, [1, 2, 2])
    resumed = vd.train(dataclasses.replace(cfg, checkpoint=str(tmp_path / "step_0000004"),
                                           max_steps=6, eval_interval=0))
    assert resumed.state.step == 6
    assert _grain_state(str(tmp_path / "step_0000006")) == _jax_position(jpipe, [2, 2, 2, 2])


def test_sparse_trainer_keeps_and_resumes_jax_record_position(toks, tmp_path):
    cfg = sd.SparseDiffusionConfig(
        platform="cpu", decoder_model=toks[3], data_pipeline="grain",
        output_dir=str(tmp_path), image_size=16, S=4, H=4, W=4, num_context=24,
        batch_size=2, eval_batch_size=2, dim=32, heads=2, depth=1, mlp_dim=24, warmup=2,
        max_steps=4, eval_interval=0, checkpoint_interval=2, log_interval=2,
        change_batch_interval=2, skip_frames=1)
    sampler = sd.build_sampler(cfg)
    assert isinstance(sampler, GrainClipPipeline)
    src = SyntheticTrajectorySource(num_trajectories=16, traj_frames=200, frame_size=16)
    want = TrajectoryClipDataset(src, traj_len=4, skip_frames=1, seed=cfg.manual_seed)
    jds = JaxClipDataset(JaxSynthetic(num_trajectories=16, traj_frames=200, frame_size=16),
                         traj_len=4, skip_frames=1, seed=cfg.manual_seed)
    assert repr(want) == repr(jds)
    np.testing.assert_array_equal(sampler.sample_batch(2), JaxPipeline(
        jds, 2, seed=cfg.manual_seed).sample_batch(2))
    sampler.close()
    sd.train(cfg)
    jpipe = JaxPipeline(jds, 2, seed=cfg.manual_seed)
    # a batch every change_batch_interval = 2 steps
    assert _grain_state(str(tmp_path / "step_0000002")) == _jax_position(jpipe, [2])
    assert _grain_state(str(tmp_path / "step_0000004")) == _jax_position(jpipe, [2])
    resumed = sd.train(dataclasses.replace(cfg, checkpoint=str(tmp_path / "step_0000004"),
                                           max_steps=6))
    assert resumed.state.step == 6
    assert _grain_state(str(tmp_path / "step_0000006")) == _jax_position(jpipe, [2])
