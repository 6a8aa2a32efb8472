"""Port parity: the evaluation utilities (``world_modelz_tpu_torch.utils``:
metrics, the FVD harness, the replayed JAX PRNG, the metric logger's
histogram and image records, GIFs and PNGs, ``cli.make_gif``) against the
JAX package.

Tolerances: PSNR, SSIM and codebook usage 1e-5 (f32 sums in another
order); the Gaussian fit, Fréchet distance and bootstrap bitwise (the same
float64 numpy code on the same features); PRNG bits bitwise, erfinv within
2 f32 ulps (numpy's log1p is not XLA's), the tiny net's normals within 3
and its scaled weights within 4 (two more f32 roundings); the tiny
features 1e-5 x max(1, max |f|) (f32 convolutions in another order); the
tokenizer features 1e-4 (as the encoder latents,
test_torch_port_tokenizer.py); grayscale GIF frames bitwise; RGB GIFs'
mean error against the source at most 1.1x PIL's own.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from world_modelz_tpu import train as jtrain  # noqa: E402
from world_modelz_tpu.cli import make_gif as jmake_gif  # noqa: E402
from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.train.checkpoint import save_checkpoint as jax_save  # noqa: E402
from world_modelz_tpu.utils import fvd as jfvd  # noqa: E402
from world_modelz_tpu.utils import image as jimage  # noqa: E402
from world_modelz_tpu.utils import logging as jlogging  # noqa: E402
from world_modelz_tpu.utils import metrics as jmetrics  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import make_gif  # noqa: E402
from world_modelz_tpu_torch.utils import fvd, image, jax_prng, metrics  # noqa: E402
from world_modelz_tpu_torch.utils.logging import MetricLogger  # noqa: E402

TOL = 1e-5
FEAT_TOL = 1e-5
TOK_FEAT_TOL = 1e-4


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("shape", [(4, 16, 16, 1), (3, 12, 20, 3)])
def test_psnr_and_ssim_match_jax(shape):
    rng = np.random.default_rng(0)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(metrics.psnr(ta, tb)),
                               float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=TOL)
    np.testing.assert_allclose(float(metrics.ssim(ta, tb)),
                               float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=TOL, atol=TOL)
    got = metrics._uniform_filter(ta, 7).numpy()
    want = np.asarray(jmetrics._uniform_filter(jnp.asarray(a), 7))
    assert got.shape == want.shape == (shape[0], shape[1] - 6, shape[2] - 6, shape[3])
    np.testing.assert_allclose(got, want, atol=TOL)


def test_codebook_usage_matches_jax():
    counts = np.random.default_rng(1).integers(0, 5, size=(2, 32)).astype(np.float32)
    counts[1, :20] = 0
    got = metrics.codebook_usage(torch.from_numpy(counts))
    want = jmetrics.codebook_usage(jnp.asarray(counts))
    for k in ("perplexity", "active_fraction"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL)


# ------------------------------------------------------------- FVD numbers


def _features(seed, n=24, d=16, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) + shift).astype(np.float32)


def test_gaussian_stats_and_frechet_distance_are_bitwise_jax():
    real, gen = _features(0), _features(1, shift=0.3)
    for p, j in zip(fvd.gaussian_stats(real), jfvd.gaussian_stats(real)):
        np.testing.assert_array_equal(p, j)
    mu1, s1 = jfvd.gaussian_stats(real)
    mu2, s2 = jfvd.gaussian_stats(gen)
    assert fvd.frechet_distance(mu1, s1, mu2, s2) == jfvd.frechet_distance(mu1, s1, mu2, s2)
    assert fvd.fvd_from_features(real, gen) == jfvd.fvd_from_features(real, gen)


@pytest.mark.parametrize("seed", [0, 3])
def test_fvd_bootstrap_is_bitwise_jax(seed):
    real, gen = _features(2), _features(3, shift=0.5)
    got = fvd.fvd_bootstrap(real, gen, n_boot=20, seed=seed)
    assert got == jfvd.fvd_bootstrap(real, gen, n_boot=20, seed=seed)
    point, lo, hi = got
    assert 0 <= lo <= point <= hi


# ------------------------------------------------- the replayed JAX PRNG


def test_prng_bits_and_keys_are_bitwise_jax():
    keys = jax.random.split(jax.random.PRNGKey(42), 4)
    mine = jax_prng.split(jax_prng.prng_key(42), 4)
    np.testing.assert_array_equal(mine, np.asarray(keys))
    for i, shape in enumerate([(7,), (3, 5, 2)]):
        np.testing.assert_array_equal(
            jax_prng.random_bits(mine[i], shape),
            np.asarray(jax.random.bits(keys[i], shape, jnp.uint32)))
    np.testing.assert_array_equal(jax_prng.prng_key(7), np.asarray(
        jax.random.key_data(jax.random.PRNGKey(7))))


def test_erfinv_and_normals_within_ulps_of_jax():
    u = np.random.default_rng(0).uniform(-1, 1, 50_000).astype(np.float32)
    assert _ulps(jax_prng.erfinv_f32(u), jax.lax.erf_inv(jnp.asarray(u))).max() <= 2
    key = jax.random.PRNGKey(7)
    n = jax_prng.normal(jax_prng.prng_key(7), (20_000,))
    assert _ulps(n, jax.random.normal(key, (20_000,))).max() <= 3


def test_tiny_weights_within_ulps_of_jax():
    keys = jax.random.split(jax.random.PRNGKey(42), 4)
    for key, w, (ci, co) in zip(keys, fvd.tiny_weights(128),
                                [(3, 32), (32, 64), (64, 128)]):
        want = jax.random.normal(key, (3, 3, 3, ci, co)) * np.sqrt(2.0 / (27 * ci))
        assert w.shape == want.shape and w.dtype == np.float32
        assert _ulps(w, want).max() <= 4


# ------------------------------------------------------------ extractors


@pytest.mark.parametrize("shape", [(3, 4, 64, 64, 1), (2, 3, 48, 40, 3)])
def test_tiny_features_match_jax(shape):
    videos = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    want = np.asarray(jfvd._tiny_forward(jnp.asarray(videos)))
    got = fvd.tiny_video_features(torch.from_numpy(videos)).numpy()
    assert got.shape == want.shape == (shape[0], 256)
    assert np.abs(got - want).max() <= FEAT_TOL * max(1.0, np.abs(want).max())
    batched = fvd.extract_features(fvd.make_extractor("tiny", device="cpu"),
                                   videos, batch_size=2)
    assert np.abs(batched - want).max() <= FEAT_TOL * max(1.0, np.abs(want).max())


TOK_CFG = dict(embedding_dim=8, num_embeddings=16, downscale_steps=2,
               hidden_planes=8, in_channels=1)


def test_tokenizer_features_match_jax(tmp_path):
    jtok = JaxTokenizer(**TOK_CFG)
    state = jax.jit(jtok.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))
    # non-trivial BatchNorm statistics, so eval mode matters
    stats = jax.tree_util.tree_map(
        lambda x: x + 0.1 * np.abs(np.random.default_rng(0).normal(size=x.shape)).astype(
            np.float32), state.batch_stats)
    state = state.replace(batch_stats=stats)
    jpath = jax_save(str(tmp_path / "jax"), 0, {"tokenizer": state}, TOK_CFG)
    ppath = convert.tokenizer_checkpoint_from_state(
        jax.device_get(state.params), jax.device_get(state.batch_stats),
        np.asarray(state.vq.codebook), TOK_CFG, str(tmp_path / "port"))
    videos = np.random.default_rng(1).uniform(size=(3, 5, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jfvd.make_extractor("tokenizer", weights=jpath)(jnp.asarray(videos)))
    ex = fvd.make_extractor("tokenizer", weights=ppath, device="cpu")
    got = fvd.extract_features(ex, videos, batch_size=2)
    assert got.shape == want.shape == (3, 4 * TOK_CFG["embedding_dim"])
    np.testing.assert_allclose(got, want, atol=TOK_FEAT_TOL)


def test_extractor_names_and_fvd_checks(monkeypatch):
    monkeypatch.delenv("WMZ_I3D_WEIGHTS", raising=False)
    with pytest.raises(ValueError, match="i3d extractor needs pretrained weights"):
        fvd.make_extractor("i3d", device="cpu")
    with pytest.raises(ValueError, match="unknown extractor"):
        fvd.make_extractor("inception", device="cpu")
    with pytest.raises(ValueError, match="tokenizer checkpoint"):
        fvd.make_extractor("tokenizer", device="cpu")
    rng = np.random.default_rng(0)
    real = rng.uniform(size=(6, 4, 32, 32, 1)).astype(np.float32)
    with pytest.raises(ValueError, match="clip shapes differ"):
        fvd.fvd(real, real[:, :3], fvd.make_extractor("tiny", device="cpu"))
    ex = fvd.make_extractor("tiny", device="cpu")
    same = fvd.fvd(real, real, ex)
    other = fvd.fvd(real, np.clip(real * 0.3 + 0.5, 0, 1), ex)
    assert abs(same) < 1e-3 < other


def test_tf32_off_restores_the_settings():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with fvd.tf32_off():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -------------------------------------------------------- metric logger


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_histogram_records_match_the_jax_logger(tmp_path):
    """The sampler's weights at one warmed-up state, through each
    package's ``loss_aware_weights`` and ``log_histogram``."""
    rng = np.random.default_rng(0)
    weights = rng.uniform(0.5, 3.0, size=100).astype(np.float32)
    counts = rng.integers(11, 40, size=100).astype(np.int32)
    jstate = jtrain.loss_aware_init().replace(
        weights=jnp.asarray(weights), counts=jnp.asarray(counts))
    pstate = ptrain.loss_aware_init()
    pstate.weights, pstate.counts = torch.from_numpy(weights), torch.from_numpy(counts)
    jw = np.asarray(jtrain.loss_aware_weights(jstate))
    pw = ptrain.loss_aware_weights(pstate)
    np.testing.assert_allclose(pw.numpy(), jw, rtol=1e-6)
    jlog = jlogging.MetricLogger(str(tmp_path / "j"), "run")
    plog = MetricLogger(str(tmp_path / "p"), "run")
    for step in (50, 100):
        jlog.log_histogram(step, "sampler_weights", jw)
        plog.log_histogram(step, "sampler_weights", pw)
    jlog.close()
    plog.close()
    want = _records(str(tmp_path / "j" / "run_metrics.jsonl"))
    got = _records(plog.path)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["step", "t", "histogram", "counts", "edges"]
        for k in ("step", "histogram", "counts", "edges"):
            assert g[k] == w[k], k
        assert len(g["counts"]) == 64 and sum(g["counts"]) == 100


def test_image_records_land_beside_the_metrics(tmp_path):
    log = MetricLogger(str(tmp_path), "run")
    img = np.random.default_rng(0).uniform(size=(10, 12, 1)).astype(np.float32)
    log.log(1, loss=np.float32(0.5))
    log.log_image(3, "reconstruction_base", img)
    log.close()
    rec = _records(log.path)
    assert rec[0]["loss"] == 0.5
    assert {k: rec[1][k] for k in ("step", "image", "path")} == {
        "step": 3, "image": "reconstruction_base",
        "path": os.path.join("images", "reconstruction_base_0000003.png")}
    png = image.read_png(str(tmp_path / rec[1]["path"]))
    np.testing.assert_array_equal(png, image._to_uint8(img))
    # wandb is not installed: the logger warns and writes the JSONL alone
    wlog = MetricLogger(str(tmp_path), "w", use_wandb=True, project="p", tags="a,b")
    wlog.log(1, loss=0.5)
    wlog.close()
    assert [r["loss"] for r in _records(wlog.path)] == [0.5]


# -------------------------------------------------------- GIFs and PNGs


def _pil_frames(path, mode):
    im, out = Image.open(path), []
    try:
        while True:
            out.append(np.asarray(im.convert(mode)))
            im.seek(im.tell() + 1)
    except EOFError:
        return np.stack(out)


def _smooth_rgb(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    rgb = np.stack([x * y, 1 - x, np.abs(np.sin(6 * y))], -1)
    return np.clip(rgb + 0.05 * rng.normal(size=rgb.shape), 0, 1).astype(np.float32)


def test_grayscale_gif_frames_are_lossless(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.uniform(size=(70, 300, 1)).astype(np.float32) for _ in range(3)]
    frames.append(np.zeros((70, 300, 1), np.float32))
    want = np.stack([image._to_uint8(f)[..., 0] for f in frames])
    image.save_gif(frames, str(tmp_path / "p.gif"), fps=4)
    jimage.save_gif(frames, str(tmp_path / "j.gif"), fps=4)
    # the port's GIF decodes (by PIL and by the port) to the uint8 frames,
    # as the JAX writer's does
    np.testing.assert_array_equal(_pil_frames(str(tmp_path / "p.gif"), "L"), want)
    np.testing.assert_array_equal(image.read_gif(str(tmp_path / "p.gif"))[..., 0], want)
    np.testing.assert_array_equal(_pil_frames(str(tmp_path / "j.gif"), "L")[:3], want[:3])
    with Image.open(str(tmp_path / "p.gif")) as im:
        assert im.info["loop"] == 0 and im.info["duration"] == 250 and im.n_frames == 4


def test_rgb_gif_dithers_as_well_as_pil(tmp_path):
    frames = [_smooth_rgb(0), _smooth_rgb(1)]
    src = np.stack([image._to_uint8(f) for f in frames]).astype(np.float64)
    image.save_gif(frames, str(tmp_path / "p.gif"), fps=5)
    jimage.save_gif(frames, str(tmp_path / "j.gif"), fps=5)
    got = image.read_gif(str(tmp_path / "p.gif"))
    np.testing.assert_array_equal(_pil_frames(str(tmp_path / "p.gif"), "RGB"), got)
    # only web-palette colours, dithered no worse than PIL dithers them
    assert set(np.unique(got)) <= set(range(0, 256, 51))
    pil_err = np.abs(_pil_frames(str(tmp_path / "j.gif"), "RGB") - src).mean()
    assert np.abs(got - src).mean() <= 1.1 * pil_err
    np.testing.assert_array_equal(image.read_gif(str(tmp_path / "j.gif")),
                                  _pil_frames(str(tmp_path / "j.gif"), "RGB"))


def test_lzw_round_trip_fills_and_clears_its_table():
    data = np.random.default_rng(0).integers(0, 256, 40_000).astype(np.uint8).tobytes()
    coded = image._lzw_encode(data)
    assert image._lzw_decode(coded, 8, len(data)) == data
    with pytest.raises(ValueError, match="pixels"):
        image._lzw_decode(coded[:100], 8, len(data))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_png_reads_pil_pngs(tmp_path, mode):
    rgb = image._to_uint8(_smooth_rgb(2))
    arr = {"L": rgb[..., 0], "RGB": rgb,
           "RGBA": np.concatenate([rgb, rgb[..., :1]], -1)}[mode]
    Image.fromarray(arr).save(str(tmp_path / "a.png"))  # PIL's adaptive filters
    got = image.read_png(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(got, arr.reshape(*arr.shape[:2], -1))
    image.save_image(rgb.astype(np.float32) / 255, str(tmp_path / "b.png"))
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "b.png")), rgb)


def test_read_png_rejects_other_pngs(tmp_path):
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(str(tmp_path / "p.png"))
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(str(tmp_path / "i.png"))
    for name in ("p.png", "i.png"):
        with pytest.raises(ValueError, match="read_png takes 8-bit"):
            image.read_png(str(tmp_path / name))
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        image.read_png(str(tmp_path / "x.png"))


def test_make_gif_matches_the_jax_cli(tmp_path):
    frames = [_smooth_rgb(i, 24, 30) for i in range(3)]
    for i, f in enumerate(frames):
        jimage.save_image(f, str(tmp_path / f"frame_{i:04d}.png"))
    pattern = str(tmp_path / "frame_*.png")
    make_gif.run(make_gif.MakeGifConfig(pattern=pattern, output=str(tmp_path / "p.gif")))
    jmake_gif.run(jmake_gif.MakeGifConfig(pattern=pattern, output=str(tmp_path / "j.gif")))
    src = np.stack([image._to_uint8(f) for f in frames]).astype(np.float64)
    got, want = image.read_gif(str(tmp_path / "p.gif")), _pil_frames(str(tmp_path / "j.gif"), "RGB")
    assert got.shape == want.shape == (3, 24, 30, 3)
    assert np.abs(got - src).mean() <= 1.1 * np.abs(want - src).mean()
    with Image.open(str(tmp_path / "p.gif")) as im:
        assert im.info["duration"] == 200
    with pytest.raises(FileNotFoundError, match="no frames"):
        make_gif.run(make_gif.MakeGifConfig(pattern=str(tmp_path / "none_*.png")))
