"""Port parity: the data sources of the trainers' remaining datasets
(``VideoFileTrajectorySource``, ``SyncTrajectorySampler``,
``TrajectoryClipDataset``, ``load_file_list``/``FileListImageDataset``,
``cli.sample_frames``) against the JAX package's on the same files and
seeds, all equal; and the trainers' ``--dataset video`` (denoiser, sparse),
``synthetic`` (denoiser) and ``files`` (tokenizer) end to end on the CPU.

The videos and images are small files the tests write themselves (cv2 and
PIL); no corpus ships with the repo."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from world_modelz_tpu.cli import sample_frames as jsf  # noqa: E402
from world_modelz_tpu.data import images as jimages  # noqa: E402
from world_modelz_tpu.data import trajectory as jtraj  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import sample_frames as psf  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.cli import train_vqae as tv  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.data import (  # noqa: E402
    FileListImageDataset,
    SyncTrajectorySampler,
    SyntheticTrajectorySource,
    TrajectoryClipDataset,
    VideoFileTrajectorySource,
    load_file_list,
)
from world_modelz_tpu_torch.models import VQAutoEncoder  # noqa: E402


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """Two small mp4s (one in a subdirectory), 48x32, 40 frames."""
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(0)
    for name in ("a.mp4", "sub/b.mp4"):
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 32))
        assert w.isOpened()
        for t in range(40):
            frame = np.full((32, 48, 3), t * 5 % 255, np.uint8)
            frame[:, :8] = rng.integers(0, 255, (32, 8, 3), dtype=np.uint8)
            w.write(frame)
        w.release()
    (root / "notes.txt").write_text("not a video")
    return str(root)


def test_video_file_source_frames_equal_jax(video_dir):
    ours = VideoFileTrajectorySource(video_dir, frame_size=16)
    theirs = jtraj.VideoFileTrajectorySource(video_dir, frame_size=16)
    assert list(ours.trajectory_names()) == list(theirs.trajectory_names()) == [
        "a.mp4", os.path.join("sub", "b.mp4")]
    assert ours.EXTENSIONS == theirs.EXTENSIONS
    for name in ours.trajectory_names():
        got = np.stack(list(ours.load_frames(name)))
        assert got.shape == (40, 16, 16, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.stack(list(theirs.load_frames(name))))
    flat = VideoFileTrajectorySource(video_dir, frame_size=16, recursive=False)
    assert list(flat.trajectory_names()) == ["a.mp4"]
    with pytest.raises(FileNotFoundError):
        VideoFileTrajectorySource(os.path.join(video_dir, "sub", "missing"))


def test_sync_sampler_equals_jax_across_buffer_refills():
    kw = dict(buffer_size=40, max_segment_length=24, traj_len=5, skip_frames=1, seed=3)
    src = SyntheticTrajectorySource(num_trajectories=3, traj_frames=50, frame_size=16, seed=2)
    jsrc = jtraj.SyntheticTrajectorySource(num_trajectories=3, traj_frames=50, frame_size=16,
                                           seed=2)
    ours, theirs = SyncTrajectorySampler(src, **kw), jtraj.SyncTrajectorySampler(jsrc, **kw)
    for _ in range(6):  # more clips than one buffer holds
        a, b = ours.sample_batch(3), theirs.sample_batch(3)
        assert a.shape == (3, 5, 16, 16, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    ours.close()


def test_trajectory_clip_dataset_records_equal_jax(video_dir):
    for make in (lambda m: m.SyntheticTrajectorySource(num_trajectories=3, traj_frames=60,
                                                      frame_size=16, seed=1),
                 lambda m: m.VideoFileTrajectorySource(video_dir, frame_size=16)):
        import world_modelz_tpu_torch.data.trajectory as ptraj

        kw = dict(traj_len=5, skip_frames=1, examples_per_epoch=50, seed=9, cache_size=1)
        ours = TrajectoryClipDataset(make(ptraj), **kw)
        theirs = jtraj.TrajectoryClipDataset(make(jtraj), **kw)
        assert repr(ours) == repr(theirs) and len(ours) == 50
        for i in (0, 11, 12, 49, 11):
            np.testing.assert_array_equal(ours[i], theirs[i], err_msg=str(i))
    short = TrajectoryClipDataset(SyntheticTrajectorySource(num_trajectories=2, traj_frames=6,
                                                            frame_size=16), traj_len=5)
    with pytest.raises(ValueError, match="traj_len"):
        short[0]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    (d / "nested").mkdir()
    for i in range(7):
        arr = np.random.default_rng(i).integers(0, 256, (16, 16, 3)).astype(np.uint8)
        Image.fromarray(arr).save(d / ("nested" if i % 2 else ".") / f"f{i}.png")
    (d / "bad.png").write_bytes(b"not a png")
    (d / "skip.jpg").write_bytes(b"filtered out by the regex")
    return d


def test_file_list_and_image_batches_equal_jax(image_dir, tmp_path):
    pattern = str(image_dir / "**" / "*")
    ours = load_file_list(str(tmp_path / "p" / "list.json"), pattern, r".*\.png$")
    theirs = jimages.load_file_list(str(tmp_path / "j" / "list.json"), pattern, r".*\.png$")
    assert sorted(ours) == sorted(theirs) and len(ours) == 8
    assert load_file_list(str(tmp_path / "p" / "list.json"), "unused") == ours  # cached
    a = FileListImageDataset(ours, batch_size=3, seed=4)
    b = jimages.FileListImageDataset(ours, batch_size=3, seed=4)
    for _ in range(5):  # across epochs and past the undecodable file
        x, y = a.next_batch(), b.next_batch()
        assert x.shape == (3, 16, 16, 3) and x.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    assert a.epoch == b.epoch >= 2
    bad = ours.index(str(image_dir / "bad.png"))
    np.testing.assert_array_equal(a[bad], b[bad])
    with pytest.raises(RuntimeError, match="No files"):
        load_file_list(str(tmp_path / "none.json"), pattern, r".*\.bmp$")


def test_sample_frames_writes_jax_manifest_and_frames(tmp_path):
    kw = dict(max_trajectories=2, skip_frames_min=20, skip_frames_max=30, manual_seed=1)
    ours = psf.run(psf.SampleFramesConfig(output_dir=str(tmp_path / "p"), **kw))
    theirs = jsf.run(jsf.SampleFramesConfig(output_dir=str(tmp_path / "j"), **kw))
    rel = [os.path.relpath(f, tmp_path / "p") for f in ours]
    assert rel == [os.path.relpath(f, tmp_path / "j") for f in theirs] and len(rel) > 10
    with open(tmp_path / "p" / "file_list.json") as f:
        assert json.load(f) == ours
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(Image.open(a).convert("RGB")),
                                      np.asarray(Image.open(b).convert("RGB")))
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        psf.run(psf.SampleFramesConfig(dataset="minerl", output_dir=str(tmp_path / "m")))


def test_sample_frames_refuses_data_dir(capsys):
    # only the unported minerl source would read it
    with pytest.raises(SystemExit):
        psf.main(["--data_dir", "/d"])
    assert "unrecognized arguments: --data_dir" in capsys.readouterr().err


RGB_TOK = dict(embedding_dim=8, num_embeddings=16, downscale_steps=2, hidden_planes=8,
               in_channels=3)


@pytest.fixture(scope="module")
def rgb_tok(tmp_path_factory):
    torch.manual_seed(0)
    tok = VQAutoEncoder(**RGB_TOK, device="cpu")
    return ptrain.save_checkpoint(str(tmp_path_factory.mktemp("rgbtok")), 0,
                                  {"tokenizer": tok.state_dict()}, RGB_TOK)


def _video_cfg(tok, out, **kw):
    base = dict(platform="cpu", decoder_model=tok, output_dir=str(out), batch_size=2,
                n_past=2, image_size=16, dim=32, depth=1, mlp_dim=24, dim_head=16, heads=2,
                extents=(1, 1, 1), warmup=2, max_steps=4, eval_interval=4, eval_timesteps=1,
                eval_batch_size=2, num_eval_iterations=2, checkpoint_interval=4,
                log_interval=2, buffer_size=100, skip_frames=1)
    base.update(kw)
    return vd.VideoDiffusionConfig(**base)


@pytest.mark.parametrize("dataset", ["synthetic", "video"])
def test_denoiser_trains_on_trajectory_datasets(rgb_tok, video_dir, tmp_path, dataset):
    cfg = _video_cfg(rgb_tok, tmp_path, dataset=dataset,
                     data_dir=video_dir if dataset == "video" else "")
    clip_fn, sampler = vd.build_clip_fn(cfg, 7)
    try:
        clips = clip_fn(3)
        assert clips.dtype == np.uint8 and clips.shape == (3, 3, 16, 16, 3)
    finally:
        sampler.close()
    result = vd.train(cfg)
    assert result.state.step == 4 and all(np.isfinite(h[1]) for h in result.history)
    assert [e[1] for e in result.evals] == ["base"]
    assert os.path.isdir(tmp_path / "step_0000004")


def test_sparse_trainer_trains_on_video_files(rgb_tok, video_dir, tmp_path):
    cfg = sd.SparseDiffusionConfig(
        platform="cpu", decoder_model=rgb_tok, output_dir=str(tmp_path), dataset="video",
        mlr_data_dir=video_dir, image_size=16, S=4, H=4, W=4, num_context=24, batch_size=2,
        eval_batch_size=2, dim=32, heads=2, depth=1, mlp_dim=24, warmup=2, max_steps=4,
        eval_interval=0, checkpoint_interval=4, log_interval=2, buffer_size=40,
        skip_frames=1, change_batch_interval=2)
    sampler = sd.build_sampler(cfg)
    try:
        assert isinstance(sampler.source, VideoFileTrajectorySource)
        assert sampler.sample_batch(2).shape == (2, 4, 16, 16, 3)
    finally:
        sampler.close()
    result = sd.train(cfg)
    assert result.state.step == 4 and all(np.isfinite(h[1]) for h in result.history)


def test_tokenizer_trains_on_image_files(image_dir, tmp_path):
    cfg = tv.TrainVqaeConfig(
        **RGB_TOK, platform="cpu", dataset="files", image_size=16, batch_size=2,
        max_steps=3, log_interval=1, checkpoint_interval=3, vq_reuse_interval=0,
        file_list_fn=str(tmp_path / "list.json"), image_dir_path=str(image_dir / "**" / "*"),
        output_dir=str(tmp_path / "run"))
    fn, pipe = tv.build_batch_fn(cfg, 0)
    want = jimages.FileListImageDataset(load_file_list(cfg.file_list_fn, "unused"), 2, seed=0)
    assert pipe is None
    np.testing.assert_array_equal(fn(), want.next_batch())
    result = tv.train(cfg)
    assert result.state.step == 3 and all(np.isfinite(h["loss"]) for h in result.history)


@pytest.mark.parametrize("train", ["video", "sparse"])
def test_minerl_keeps_raising(rgb_tok, tmp_path, train):
    if train == "video":
        cfg = _video_cfg(rgb_tok, tmp_path, dataset="minerl")
        run = vd.train
    else:
        cfg = sd.SparseDiffusionConfig(platform="cpu", decoder_model=rgb_tok, dataset="minerl")
        run = sd.train
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        run(cfg)
