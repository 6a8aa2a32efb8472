"""Port parity: rollout and evaluation (``cli.rollout``, the denoiser
trainer's ``evaluate_and_save``, ``--eval`` and its metric log,
``unmask_frame``'s ``topk_from_iteration``) against the JAX package, on a
small denoiser on the CPU.

The JAX sampler's draws are replayed into the port (as in
test_torch_port_serve.py), so the same weights must give the same tokens
exactly; pixels after decode agree within 1e-4 (f32 convolutions summed in
another order), PSNR within 1e-2 dB and SSIM within 1e-3 of JAX's on
those pixels.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.cli import video_diffusion as jvd  # noqa: E402
from world_modelz_tpu.diffusion import masked as jmasked  # noqa: E402
from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.models.video import (  # noqa: E402
    VqVideoDiffusionModel as JaxDenoiser,
)
from world_modelz_tpu.utils import metrics as jmetrics  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import rollout as ro  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.diffusion import masked as pmasked  # noqa: E402
from world_modelz_tpu_torch.utils import fvd as pfvd  # noqa: E402
from world_modelz_tpu_torch.utils.config import config_to_dict  # noqa: E402
from world_modelz_tpu_torch.utils.image import read_gif, read_png  # noqa: E402

S, IMG, C, K, D = 3, 16, 1, 16, 8
TH = IMG // 4
PIX_TOL = 1e-4
PSNR_TOL = 1e-2
SSIM_TOL = 1e-3
TOK_CFG = dict(embedding_dim=D, num_embeddings=K, downscale_steps=2,
               hidden_planes=8, in_channels=C)
MODEL = dict(dim=32, depth=2, mlp_dim=24, dim_head=16, heads=2, extents=(1, 1, 1))


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """A JAX tokenizer + denoiser, the port's tokenizer checkpoint of the
    same weights, and a port training checkpoint (step 7) holding the
    denoiser's weights as params and a scaled copy as EMA."""
    jtok = JaxTokenizer(**TOK_CFG)
    tok_state = jax.jit(jtok.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, C)))
    tok_path = convert.tokenizer_checkpoint_from_state(
        jax.device_get(tok_state.params), jax.device_get(tok_state.batch_stats),
        np.asarray(tok_state.vq.codebook), TOK_CFG,
        str(tmp_path_factory.mktemp("tok")))
    jm = JaxDenoiser(data_shape=(S, TH, TH), num_classes=K, backend="xla", **MODEL)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, S, TH, TH), jnp.int32))["params"])
    ema = jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(0.5), params)
    cfg = vd.VideoDiffusionConfig(
        platform="cpu", decoder_model=tok_path, n_past=S - 1, image_size=IMG,
        digit_size=6, tok_bf16=False, eval_batch_size=2, eval_timesteps=2,
        num_eval_iterations=3, **MODEL)
    ckpt = ptrain.save_checkpoint(
        str(tmp_path_factory.mktemp("run")), 7,
        {"params": convert.video_state_dict_from_params(params),
         "ema": convert.video_state_dict_from_params(ema),
         "opt_state": {}, "sampler": {}},
        config_to_dict(cfg))
    return dict(jtok=jtok, tok_state=tok_state, tok_path=tok_path, jm=jm,
                params=params, ema=ema, cfg=cfg, ckpt=ckpt)


def _jax_clip_fn(cfg, seed, n_past=S - 1):
    jcfg = jvd.VideoDiffusionConfig(n_past=n_past, image_size=IMG, digit_size=6)
    return jvd.build_clip_fn(jcfg, seed)[0]


def _jax_draws(key, num_frames, num_iterations, b):
    """The (gumbel, uniform) pairs JAX's rollout_frames consumes, in its key
    order (masked.py:112, 122-128, 170), as the port's ``noise``."""
    draws = {}
    for t in range(num_frames):
        key, sub = jax.random.split(key)
        for i in range(num_iterations):
            sub, k_draw, k_mask = jax.random.split(sub, 3)
            g = jax.random.gumbel(k_draw, (b * TH * TH, K), jnp.float32)
            u = jax.random.uniform(k_mask, (b, TH, TH))
            draws[t, i] = (torch.from_numpy(np.array(g)), torch.from_numpy(np.array(u)))
    return lambda t, i: draws[t, i]


def _replay(monkeypatch, module, keys):
    """Make ``module``'s rollout_frames draw call n's noise from JAX's key
    ``keys[n]``; returns the list of the tokens each call generated."""
    calls = []
    real = pmasked.rollout_frames

    def replayed(logits_fn, context, *, generator=None, **kw):
        noise = _jax_draws(keys[len(calls)], kw["num_frames"], kw["num_iterations"],
                           context.shape[0])
        out = real(logits_fn, context, noise=noise, **kw)
        calls.append(out.numpy())
        return out

    monkeypatch.setattr(module, "rollout_frames", replayed)
    return calls


def _jax_generate(st, frames, key, num_frames, iters, topk, params=None):
    """JAX's rollout of float frames (B, S, H, W, C): (tokens, pixels)."""
    jtok, tok_state, jm = st["jtok"], st["tok_state"], st["jm"]
    params = st["params"] if params is None else params
    x = jnp.asarray(frames, jnp.float32)
    b, s = x.shape[:2]
    toks = jtok.encode(tok_state, x.reshape(b * s, IMG, IMG, C)).reshape(b, s, TH, TH)
    gen = jmasked.rollout_frames(
        key, lambda z: jm.apply({"params": params}, z), toks, num_frames=num_frames,
        num_classes=K, mask_token=K, num_iterations=iters, sample_topk=topk)
    t = gen.shape[1]
    dec = jtok.decode(tok_state, gen.reshape(b * t, TH, TH)).reshape(b, t, IMG, IMG, C)
    return np.asarray(gen), np.asarray(dec)


# --------------------------------------------------------------- sampler


@pytest.mark.parametrize("topk_from", [0, 1])
def test_unmask_frame_topk_from_iteration_matches_jax(stack, topk_from):
    jm, params = stack["jm"], stack["params"]
    pm = vd.make_model(stack["cfg"], (S, TH, TH), K, "cpu").eval()
    pm.load_state_dict(convert.video_state_dict_from_params(params), strict=True)
    ctx = np.random.default_rng(0).integers(0, K, size=(2, S, TH, TH)).astype(np.int32)
    key, iters = jax.random.PRNGKey(3), 4
    ref = np.asarray(jmasked.unmask_frame(
        key, lambda z: jm.apply({"params": params}, z), jnp.asarray(ctx),
        num_classes=K, mask_token=K, num_iterations=iters, sample_topk=3,
        topk_from_iteration=topk_from))
    draws, sub = [], key
    for _ in range(iters):
        sub, k_draw, k_mask = jax.random.split(sub, 3)
        draws.append((torch.from_numpy(np.array(jax.random.gumbel(k_draw, (2 * TH * TH, K)))),
                      torch.from_numpy(np.array(jax.random.uniform(k_mask, (2, TH, TH))))))
    with torch.no_grad():
        got = pmasked.unmask_frame(
            pm, torch.from_numpy(ctx), num_classes=K, mask_token=K,
            num_iterations=iters, sample_topk=3, topk_from_iteration=topk_from,
            noise=lambda i: draws[i])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_topk_from_iteration_changes_the_first_draw():
    """With top-k from iteration 0 the first draw (from flat logits) is
    filtered too; from 1 it is not: the first step's logits decide."""
    logits = torch.tensor([[[[0.0, 5.0, 1.0]]]])
    gumbel = torch.tensor([[[[9.0, 0.0, 0.0]]]])
    z = torch.zeros((1, 2, 1, 1), dtype=torch.long)
    kw = dict(num_iterations=4, mask_token=3, sample_topk=1)
    first = pmasked.unmask_step(0, z, logits, gumbel, torch.zeros(1, 1, 1), **kw)
    assert int(first[0, -1]) == 0  # no filter at iteration 0 by default
    zero = pmasked.unmask_step(0, z, logits, gumbel, torch.zeros(1, 1, 1),
                               topk_from_iteration=0, **kw)
    assert int(zero[0, -1]) == 1


# ---------------------------------------------------------- evaluation


def test_evaluate_and_save_matches_jax_under_its_draws(stack, tmp_path, monkeypatch):
    st, cfg = stack, dataclasses.replace(stack["cfg"], output_dir=str(tmp_path), topk=4)
    clip = _jax_clip_fn(cfg, 5)(cfg.eval_batch_size)
    tok, _ = vd.load_tokenizer(st["tok_path"], "cpu")
    pm = vd.make_model(cfg, (S, TH, TH), K, "cpu")  # train mode, as the trainer's
    ema = {k: torch.as_tensor(v) for k, v in convert.video_state_dict_from_params(st["ema"]).items()}
    pm.load_state_dict(convert.video_state_dict_from_params(st["params"]), strict=True)
    key = jax.random.PRNGKey(11)
    calls = _replay(monkeypatch, vd, [key, key])
    decoded = []
    real_decode = tok.decode
    monkeypatch.setattr(tok, "decode", lambda z: decoded.append(real_decode(z)) or decoded[-1])
    logger = vd.MetricLogger(str(tmp_path), cfg.name)
    for tag, weights, params in (("base", None, st["params"]), ("ema", ema, st["ema"])):
        path = vd.evaluate_and_save(
            cfg=cfg, model=pm, weights=weights, tok=tok, clip_fn=lambda b: clip,
            generator=torch.Generator().manual_seed(0), tag=tag, step=3,
            logger=logger, save_frames=True)
        gen, pix = _jax_generate(st, clip / 255.0, key, cfg.eval_timesteps,
                                 cfg.num_eval_iterations, cfg.topk, params)
        np.testing.assert_array_equal(calls[-1], gen)
        got = decoded[-1].numpy().reshape(pix.shape)
        assert np.abs(got - pix).max() <= PIX_TOL
        assert pm.training  # the trainer's mode is given back
        assert path == os.path.join(str(tmp_path), f"{cfg.name}_eval_0000003_{tag}.png")
        grid = read_png(path)
        rows = read_gif(path[:-4] + ".gif")
        t = cfg.eval_timesteps + 1
        assert rows.shape[0] == t and grid.shape[0] == t * (IMG + 2) + 2
        for i in range(t):  # the GIF's frames are the grid's rows
            np.testing.assert_array_equal(rows[i, ..., :1], grid[i * (IMG + 2):(i + 1) * (IMG + 2) + 2])
            frame = read_png(os.path.join(str(tmp_path), f"{cfg.name}_{tag}_frame_{i:04d}.png"))
            np.testing.assert_array_equal(frame, rows[i, ..., :1])
    logger.close()
    with open(logger.path) as f:
        rec = [json.loads(line) for line in f]
    assert [(r["step"], r["image"]) for r in rec] == [(3, "reconstruction_base"),
                                                       (3, "reconstruction_ema")]
    np.testing.assert_array_equal(read_png(os.path.join(str(tmp_path), rec[0]["path"])),
                                  read_png(os.path.join(str(tmp_path), f"{cfg.name}_eval_0000003_base.png")))


def _tiny_train(st, out, **kw):
    base = dict(output_dir=str(out), batch_size=2, warmup=2, max_steps=4,
                checkpoint_interval=0, log_interval=2, ema_decay=0.9, bf16=True,
                lr=1e-3)
    base.update(kw)
    return dataclasses.replace(st["cfg"], **base)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_trainer_logs_metrics_and_histograms_as_jax(stack, tmp_path):
    """C.8 and C.9: loss, grad_norm, lr and steps_per_sec at each log
    point, and the sampler weights' histogram every histogram_interval
    steps, as the JAX trainer writes them (cli/video_diffusion.py:757-763,
    :867-872)."""
    cfg = _tiny_train(stack, tmp_path, histogram_interval=2, eval_interval=0)
    result = vd.train(cfg)
    rec = _records(os.path.join(str(tmp_path), "vq_diffusion_metrics.jsonl"))
    scalars = [r for r in rec if "loss" in r]
    hists = [r for r in rec if "histogram" in r]
    assert [r["step"] for r in scalars] == [1, 2, 4]
    losses = {h[0]: h for h in result.history}
    lr = ptrain.host_schedule(result.state.optimizer.schedule)
    for r in scalars:
        assert list(r) == ["step", "t", "loss", "grad_norm", "lr", "steps_per_sec"]
        assert r["loss"] == losses[r["step"]][1] and r["grad_norm"] == losses[r["step"]][2]
        assert r["lr"] == lr(r["step"]) and r["steps_per_sec"] > 0
    assert [(r["step"], r["histogram"]) for r in hists] == [(2, "sampler_weights"),
                                                            (4, "sampler_weights")]
    counts, edges = np.histogram(
        ptrain.loss_aware_weights(result.state.sampler).numpy(), bins=64)
    assert hists[-1]["counts"] == counts.tolist()
    assert hists[-1]["edges"] == np.round(edges, 6).tolist()


def test_trainer_evaluates_base_and_ema_every_interval(stack, tmp_path):
    cfg = _tiny_train(stack, tmp_path, eval_interval=2, histogram_interval=0)
    result = vd.train(cfg)
    assert [(e[0], e[1]) for e in result.evals] == [(2, "base"), (2, "ema"),
                                                    (4, "base"), (4, "ema")]
    files = os.listdir(tmp_path)
    for step in (2, 4):
        for tag in ("base", "ema"):
            for ext in ("png", "gif"):
                assert f"vq_diffusion_eval_{step:07d}_{tag}.{ext}" in files
    images = [r for r in _records(os.path.join(str(tmp_path), "vq_diffusion_metrics.jsonl"))
              if "image" in r]
    assert [(r["step"], r["image"]) for r in images] == [
        (2, "reconstruction_base"), (2, "reconstruction_ema"),
        (4, "reconstruction_base"), (4, "reconstruction_ema")]


def test_trainer_eval_only_writes_the_artifacts(stack, tmp_path):
    cfg = _tiny_train(stack, tmp_path, eval=True, checkpoint=stack["ckpt"])
    result = vd.train(cfg)
    assert result.history == [] and result.state.step == 7
    assert [(e[0], e[1]) for e in result.evals] == [(7, "base")]
    want = convert.video_state_dict_from_params(stack["params"])
    for k, v in result.state.model.state_dict().items():
        assert torch.equal(v, torch.as_tensor(want[k])), k
    files = os.listdir(tmp_path)
    assert "vq_diffusion_eval_0000007_base.png" in files
    assert "vq_diffusion_eval_0000007_base.gif" in files
    frames = sorted(f for f in files if f.startswith("vq_diffusion_base_frame_"))
    assert len(frames) == cfg.eval_timesteps + 1
    rec = _records(os.path.join(str(tmp_path), "vq_diffusion_metrics.jsonl"))
    assert [(r["step"], r["image"]) for r in rec] == [(7, "reconstruction_base")]


# flags the evaluation and the metric log read: accepted at any value now
EVAL_FLAGS = [
    dict(eval=True), dict(eval_interval=2), dict(histogram_interval=0),
    dict(topk=5), dict(eval_timesteps=2), dict(eval_batch_size=2),
    dict(num_eval_iterations=2),
]


@pytest.mark.parametrize("kw", EVAL_FLAGS, ids=lambda kw: next(iter(kw)))
def test_evaluation_flags_are_supported(stack, kw):
    vd.check_supported(dataclasses.replace(stack["cfg"], **kw))
    vd.check_supported(vd.VideoDiffusionConfig())  # the defaults


# ----------------------------------------------------------- rollout CLI


def test_rollout_run_matches_jax_under_its_draws(stack, tmp_path, monkeypatch):
    st = stack
    keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
    calls = _replay(monkeypatch, ro, keys)
    # 10 resamples, not 200: each takes two 256 x 256 eigendecompositions
    bootstrap = pfvd.fvd_bootstrap
    monkeypatch.setattr(pfvd, "fvd_bootstrap", functools.partial(bootstrap, n_boot=10))
    cfg = ro.RolloutConfig(
        checkpoint=st["ckpt"], platform="cpu", batch_size=2, num_frames=2,
        num_eval_iterations=3, topk=4, manual_seed=4, output_dir=str(tmp_path),
        fvd=True, fvd_clips=4, fvd_batch_size=3, gt_metrics=True)
    result = ro.run(cfg)
    b, t = 2, 2
    assert result.step == 7 and len(calls) == 3 and len(result.batch_seconds) == 3

    # the first batch: the data source's clips under the port's seed
    clip = _jax_clip_fn(st["cfg"], cfg.manual_seed)(b) / 255.0
    gen, pix = _jax_generate(st, clip, keys[0], t, 3, 4)
    np.testing.assert_array_equal(calls[0], gen)
    assert result.decoded.shape == pix.shape == (b, t, IMG, IMG, C)
    assert np.abs(result.decoded - pix).max() <= PIX_TOL

    # frames, then the GIF of the same grids
    gif = read_gif(os.path.join(str(tmp_path), "rollout.gif"))
    assert gif.shape[0] == t
    for i in range(t):
        png = read_png(os.path.join(str(tmp_path), f"rollout_frame_{i:04d}.png"))
        np.testing.assert_array_equal(gif[i, ..., :1], png)

    # FVD: the real clips are the data source's (seed + 1) at the rollout's
    # length; the record is the bootstrap of the tiny features
    real = _jax_clip_fn(st["cfg"], cfg.manual_seed + 1, n_past=t - 1)(4) / 255.0
    np.testing.assert_array_equal(result.real_videos, real.astype(np.float32))
    assert result.gen_videos.shape == (4, t, IMG, IMG, C)
    np.testing.assert_array_equal(result.gen_videos[:b], result.decoded)
    ex = pfvd.make_extractor("tiny", device="cpu")
    score, lo, hi = bootstrap(pfvd.extract_features(ex, real, 3),
                              pfvd.extract_features(ex, result.gen_videos, 3),
                              n_boot=10, seed=cfg.manual_seed)
    with open(os.path.join(str(tmp_path), "rollout_fvd.json")) as f:
        assert json.load(f) == result.fvd
    assert result.fvd == {"step": 7, "fvd": score, "fvd_ci95": [lo, hi],
                          "feature_net": "tiny", "clips": 4, "frames_per_clip": t}

    # gt metrics: the held-out continuations of the seed + 2 clips
    long = _jax_clip_fn(st["cfg"], cfg.manual_seed + 2, n_past=S - 1 + t - 1)(b) / 255.0
    seed_clip, gt = long[:, :S], long[:, S - 1:S - 1 + t]
    gen, pred = _jax_generate(st, seed_clip, keys[2], t, 3, 4)
    np.testing.assert_array_equal(calls[2], gen)
    jtok, tok_state = st["jtok"], st["tok_state"]
    flat = jnp.asarray(gt.reshape(-1, IMG, IMG, C), jnp.float32)
    ceiling = np.asarray(jtok.decode(tok_state, jtok.encode(tok_state, flat))).reshape(gt.shape)
    rec = result.gt_metrics
    with open(os.path.join(str(tmp_path), "rollout_gt_metrics.json")) as f:
        assert json.load(f) == rec
    assert rec["step"] == 7 and rec["clips"] == b and len(rec["per_horizon"]) == t
    for m, h in enumerate(rec["per_horizon"]):
        p, g = jnp.asarray(pred[:, m]), jnp.asarray(gt[:, m], jnp.float32)
        assert h["horizon"] == m + 1
        assert abs(h["psnr"] - float(jmetrics.psnr(p, g))) <= PSNR_TOL
        assert abs(h["ssim"] - float(jmetrics.ssim(p, g))) <= SSIM_TOL
        assert abs(h["tokenizer_ceiling_psnr"]
                   - float(jmetrics.psnr(jnp.asarray(ceiling[:, m]), g))) <= PSNR_TOL
    assert rec["mean_psnr"] == float(np.mean([h["psnr"] for h in rec["per_horizon"]]))


def test_rollout_presets_ema_and_checks(stack, tmp_path, capsys, monkeypatch):
    base = ro.RolloutConfig(checkpoint=stack["ckpt"], platform="cpu", batch_size=2,
                            num_frames=1, output_dir=str(tmp_path), preset="reference",
                            num_eval_iterations=2, topk=3)
    result = ro.run(base)
    assert "sampler preset reference: 30 iterations, topk -1" in capsys.readouterr().out
    assert result.rollout.cfg.num_eval_iterations == 30 and result.rollout.cfg.topk == -1
    assert result.fvd is None and result.gt_metrics is None
    assert sorted(os.listdir(tmp_path)) == ["rollout.gif", "rollout_frame_0000.png"]
    assert ro.SAMPLER_PRESETS["fast"] == dict(num_eval_iterations=10, topk=25)
    ema = ro.Rollout(dataclasses.replace(base, use_ema=True), torch.device("cpu"))
    want = convert.video_state_dict_from_params(stack["ema"])
    assert all(torch.equal(ema.weights[k], torch.as_tensor(want[k])) for k in want)
    with pytest.raises(ValueError, match="unknown preset"):
        ro.run(dataclasses.replace(base, preset="slow"))
    # --shard_batch in one process: a data axis of one, the same pixels
    sharded = ro.run(dataclasses.replace(base, shard_batch=True))
    np.testing.assert_array_equal(sharded.decoded, result.decoded)
    with pytest.raises(ValueError, match="--checkpoint"):
        ro.run(dataclasses.replace(base, checkpoint=""))
    # the I3D extractor, on weights in the JAX layout (the default init);
    # 10 resamples, not 200: each takes two 400 x 400 eigendecompositions
    monkeypatch.setattr(pfvd, "fvd_bootstrap",
                        functools.partial(pfvd.fvd_bootstrap, n_boot=10))
    weights = str(tmp_path / "i3d.npz")
    pfvd.save_i3d(pfvd.I3D(), weights)
    scored = ro.run(dataclasses.replace(
        base, preset="", num_eval_iterations=2, fvd=True, fvd_feature_net="i3d",
        fvd_weights=weights, fvd_clips=2, output_dir=str(tmp_path / "i3d")))
    assert scored.fvd["feature_net"] == "i3d" and np.isfinite(scored.fvd["fvd"])


def test_rollout_cli_with_the_tokenizer_extractor(stack, tmp_path):
    # three frames at least: the acceleration features take two differences
    ro.main(["--checkpoint", stack["ckpt"], "--platform", "cpu", "--batch_size", "2",
             "--num_frames", "3", "--num_eval_iterations", "2", "--fvd", "true",
             "--fvd_clips", "4", "--fvd_feature_net", "tokenizer",
             "--fvd_weights", stack["tok_path"], "--output_dir", str(tmp_path),
             "--name", "r"])
    with open(os.path.join(str(tmp_path), "r_fvd.json")) as f:
        rec = json.load(f)
    assert rec["feature_net"] == "tokenizer" and rec["clips"] == 4
    assert np.isfinite(rec["fvd"]) and rec["fvd_ci95"][0] <= rec["fvd"] <= rec["fvd_ci95"][1]
