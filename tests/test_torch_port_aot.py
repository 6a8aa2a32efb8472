"""Port parity: serving artifacts (``world_modelz_tpu_torch.aot``),
``RolloutService(programs=...)`` and the two serving CLIs
(``cli.export_rollout``, ``cli.serve_http``) against the live service and
the JAX package's ``aot.py``, on a small denoiser on the CPU.

On the CPU the programs run uncaptured (a CUDA graph needs the card), so
these tests cover everything but the capture itself: the artifact, the
program functions over their static buffers, the draws outside them and
the service around them. A programs service and a live one give the same
clips bit for bit under one seed; under JAX's replayed draws
(test_torch_port_serve.py) the port's programs give the tokens of JAX's
exported rollout exactly and its pixels within 1e-4 (f32 convolutions
summed in another order).
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu import aot as jaot  # noqa: E402
from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.models.video import (  # noqa: E402
    VqVideoDiffusionModel as JaxDenoiser,
)
from world_modelz_tpu_torch import aot, convert  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import export_rollout  # noqa: E402
from world_modelz_tpu_torch.cli import serve_http as serve_cli  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.diffusion.masked import (  # noqa: E402
    unmask_alpha,
    unmask_step,
)
from world_modelz_tpu_torch.models import (  # noqa: E402
    VQAutoEncoder,
    VqVideoDiffusionModel,
)
from world_modelz_tpu_torch.serve import RolloutService  # noqa: E402
from world_modelz_tpu_torch.serve_http import http_generate  # noqa: E402
from world_modelz_tpu_torch.utils.config import config_to_dict  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, IMG, C, K, D = 3, 16, 1, 16, 8
TH = IMG // 4
PIX_TOL = 1e-4
TOK_CFG = dict(embedding_dim=D, num_embeddings=K, downscale_steps=2,
               hidden_planes=8, in_channels=C)
MODEL = dict(dim=16, depth=2, mlp_dim=16, dim_head=8, heads=2, extents=(1, 1, 1))
FRAMES, ITERS = 2, 3


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """JAX tokenizer + denoiser, the port's modules on the same weights
    (``convert.py``), and a port training checkpoint of them (step 3)."""
    jtok = JaxTokenizer(**TOK_CFG)
    tok_state = jax.jit(jtok.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, C)))
    jm = JaxDenoiser(data_shape=(S, TH, TH), num_classes=K, backend="xla", **MODEL)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, S, TH, TH), jnp.int32))["params"])
    tok_path = convert.tokenizer_checkpoint_from_state(
        jax.device_get(tok_state.params), jax.device_get(tok_state.batch_stats),
        np.asarray(tok_state.vq.codebook), TOK_CFG,
        str(tmp_path_factory.mktemp("tok")))
    ptok = VQAutoEncoder(**TOK_CFG, device="cpu")
    ptok.load_state_dict(convert.tokenizer_state_dict_from_state(
        tok_state.params, tok_state.batch_stats,
        np.asarray(tok_state.vq.codebook)), strict=True)
    pm = VqVideoDiffusionModel((S, TH, TH), num_classes=K, device="cpu", **MODEL)
    pm.load_state_dict(convert.video_state_dict_from_params(params), strict=True)
    cfg = vd.VideoDiffusionConfig(
        platform="cpu", decoder_model=tok_path, n_past=S - 1, image_size=IMG,
        digit_size=6, tok_bf16=False, **MODEL)
    ckpt = ptrain.save_checkpoint(
        str(tmp_path_factory.mktemp("run")), 3,
        {"params": pm.state_dict(), "opt_state": {}, "sampler": {}},
        config_to_dict(cfg))
    return dict(jtok=jtok, tok_state=tok_state, jm=jm, params=params,
                ptok=ptok, pm=pm, ckpt=ckpt)


def _export(stack, out, sample_topk=-1, batch_size=4):
    return aot.export_service(
        str(out), stack["ptok"], stack["pm"], num_frames=FRAMES,
        num_iterations=ITERS, sample_topk=sample_topk, batch_size=batch_size,
        seed_frames=S, image_size=IMG, channels=C)


@pytest.fixture(scope="module")
def artifact(stack, tmp_path_factory):
    path = tmp_path_factory.mktemp("artifact")
    meta = _export(stack, path)
    assert meta["sizes"] == [1, 2, 4]
    return str(path)


def _live(stack, **kw):
    kw = dict(dict(num_frames=FRAMES, num_iterations=ITERS, batch_size=4,
                   max_wait_s=0.01), **kw)
    return RolloutService(stack["ptok"], stack["pm"], device="cpu", **kw)


def _clips(seed, n):
    return np.random.default_rng(seed).uniform(
        size=(n, S, IMG, IMG, C)).astype(np.float32)


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
            draws[t, i] = (torch.from_numpy(np.array(g)),
                           torch.from_numpy(np.array(u)))
    return lambda t, i: draws[t, i]


@pytest.mark.parametrize("batch_size", range(1, 18))
def test_ladder_matches_jax(batch_size):
    assert aot.ladder(batch_size) == jaot.ladder(batch_size)


def test_export_load_round_trips_every_weight(stack, artifact):
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    jax_keys = {"format", "num_frames", "num_iterations", "sample_topk",
                "sizes", "seed_frames", "image_size", "channels", "token_hw",
                "num_embeddings"}
    assert jax_keys | {"denoiser", "tokenizer", "torch_version"} == set(meta)
    assert meta["token_hw"] == [TH, TH] and meta["num_embeddings"] == K
    progs = aot.AOTPrograms.load(artifact, device="cpu")
    for mine, ref in ((progs.model, stack["pm"]), (progs.tok, stack["ptok"])):
        assert not mine.training
        got, want = mine.state_dict(), ref.state_dict()
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key
    assert progs.model.config == dict(stack["pm"].config)


@pytest.mark.parametrize("sample_topk", [-1, 4])
def test_programs_equal_live_service_at_every_size(stack, tmp_path, sample_topk):
    """The programs' encode and rollout (uncaptured) against the live
    service's ``_encode_call`` and ``_rollout_call``, with generators of one
    seed: tokens, context and pixels bitwise, at each ladder size."""
    _export(stack, tmp_path, sample_topk=sample_topk)
    progs = aot.AOTPrograms.load(str(tmp_path), device="cpu")
    live = _live(stack, sample_topk=sample_topk, seed=9)
    try:
        for b in progs.sizes:
            seeds = _clips(b, b)
            tokens = live._encode_call(seeds)
            np.testing.assert_array_equal(progs.encode(seeds), tokens)
            live._generator.manual_seed(9 + b)
            pix, ctx = live._rollout_call(tokens)
            got_pix, got_ctx = progs.rollout(
                tokens, generator=torch.Generator().manual_seed(9 + b))
            assert got_pix.shape == (b, FRAMES, IMG, IMG, C)
            np.testing.assert_array_equal(got_ctx, ctx)
            np.testing.assert_array_equal(got_pix, pix)
        with pytest.raises(ValueError, match="not in exported ladder"):
            progs.encode(_clips(0, 3))
    finally:
        live.close()


def test_programs_service_matches_live_and_streams(stack, artifact):
    clip = _clips(2, 1)[0]
    with _live(stack, seed=5) as live:
        ref = live.submit(clip).result(timeout=120)
        ref_sess = live.open_session(clip)
        ref_seg = [ref_sess.generate(), ref_sess.generate()]
    progs = aot.AOTPrograms.load(artifact, device="cpu")
    with RolloutService(programs=progs, seed=5, max_wait_s=0.01) as svc:
        assert svc.num_frames == FRAMES and svc._sizes == [1, 2, 4]
        got = svc.submit(clip).result(timeout=120)
        sess = svc.open_session(clip)
        seg = [sess.generate(), sess.generate()]
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(seg, ref_seg):
        np.testing.assert_array_equal(a, b)
    assert svc.stats["requests"] == 3 and svc.stats["session_rows"] == 2
    assert set(svc.stats) == set(live.stats)
    with pytest.raises(ValueError, match="below every exported size"):
        RolloutService(programs=progs, batch_size=0)


def test_capturable_step_equals_unmask_step(stack, tmp_path):
    """A program's step over its static buffers (alpha a 0-d f32 tensor)
    against ``unmask_step`` and the model, at every iteration, with and
    without top-k."""
    _export(stack, tmp_path, sample_topk=3, batch_size=2)
    progs = aot.AOTPrograms.load(str(tmp_path), device="cpu")
    p = progs._programs[2]
    rng = np.random.default_rng(3)
    for i in range(ITERS):
        for topk in (-1, 3):
            z = torch.from_numpy(rng.integers(0, K, size=(2, S, TH, TH)))
            logits = torch.from_numpy(
                rng.normal(size=(2, TH, TH, K)).astype(np.float32))
            gumbel = torch.from_numpy(
                rng.gumbel(size=(2, TH, TH, K)).astype(np.float32))
            uniform = torch.from_numpy(rng.uniform(size=(2, TH, TH)).astype(np.float32))
            want_z = unmask_step(i, z, logits, gumbel, uniform,
                                 num_iterations=ITERS, mask_token=K,
                                 sample_topk=topk, topk_from_iteration=0)
            with torch.inference_mode():
                want_logits = stack["pm"](want_z)
                for buf, val in ((p.z, z), (p.logits, logits),
                                 (p.gumbel, gumbel), (p.uniform, uniform)):
                    buf.copy_(val)
                p.alpha.fill_(unmask_alpha(i, ITERS))
                p.fns["step_topk" if topk > 0 else "step"]()
            assert torch.equal(p.z, want_z), (i, topk)
            assert torch.equal(p.logits, want_logits), (i, topk)


def test_programs_match_jax_exported_rollout(stack, artifact, tmp_path):
    """The port's programs under JAX's draws against JAX's exported
    programs (``platforms=["cpu"]``) on the same weights."""
    jdir = str(tmp_path / "jax")
    jaot.export_service(
        jdir, stack["jtok"], stack["tok_state"], stack["jm"], stack["params"],
        num_frames=FRAMES, num_iterations=ITERS, sample_topk=-1, batch_size=2,
        seed_frames=S, image_size=IMG, channels=C, platforms=["cpu"])
    jprogs = jaot.AOTPrograms.load(jdir)
    progs = aot.AOTPrograms.load(artifact, device="cpu")
    seeds = _clips(4, 2)
    ref_tokens = np.asarray(jprogs.encode(jnp.asarray(seeds)))
    np.testing.assert_array_equal(progs.encode(seeds), ref_tokens)
    key = jax.random.PRNGKey(11)
    ref_pix, ref_ctx = (np.asarray(a) for a in
                        jprogs.rollout(jnp.asarray(ref_tokens), key))
    pix, ctx = progs.rollout(ref_tokens, noise=_jax_draws(key, FRAMES, ITERS, 2))
    np.testing.assert_array_equal(ctx, ref_ctx)
    np.testing.assert_allclose(pix, ref_pix, atol=PIX_TOL, rtol=0)


def test_export_refuses_fused_and_bf16_denoisers(stack, tmp_path):
    fused = VqVideoDiffusionModel((S, TH, TH), num_classes=K, device="cpu",
                                  backend="fused", **MODEL)
    with pytest.raises(ValueError, match="fused"):
        aot.export_service(str(tmp_path), stack["ptok"], fused, num_frames=1,
                           seed_frames=S, image_size=IMG, channels=C)
    half = VqVideoDiffusionModel((S, TH, TH), num_classes=K, device="cpu",
                                 dtype=torch.bfloat16, **MODEL)
    with pytest.raises(ValueError, match="f32"):
        aot.export_service(str(tmp_path), stack["ptok"], half, num_frames=1,
                           seed_frames=S, image_size=IMG, channels=C)


def test_build_service_exported_caps_ladder_and_refuses_preset(artifact):
    svc, tag = serve_cli.build_service(serve_cli.ServeHTTPConfig(
        exported=artifact, platform="cpu", batch_size=2, max_wait_s=0.01))
    try:
        assert tag == f"aot:{artifact}" and svc._sizes == [1, 2]
        out = svc.submit(np.zeros((S, IMG, IMG, C), np.float32)).result(timeout=120)
        assert out.shape == (FRAMES, IMG, IMG, C) and np.isfinite(out).all()
    finally:
        svc.close()
    with pytest.raises(SystemExit, match="--preset"):
        serve_cli.build_service(serve_cli.ServeHTTPConfig(
            exported=artifact, platform="cpu", preset="fast"))
    with pytest.raises(SystemExit, match="unknown --preset"):
        serve_cli.build_service(serve_cli.ServeHTTPConfig(
            exported=artifact, platform="cpu", preset="nope"))


def test_build_service_from_checkpoint_serves_f32_eval(stack):
    svc, step = serve_cli.build_service(serve_cli.ServeHTTPConfig(
        checkpoint=stack["ckpt"], platform="cpu", num_frames=FRAMES,
        num_iterations=ITERS, batch_size=2, max_wait_s=0.01, manual_seed=4))
    try:
        assert step == 3 and svc._sizes == [1, 2]
        assert not svc._model.training and not svc._tok.training
        assert all(t.dtype == torch.float32 for t in svc._model.state_dict().values()
                   if t.is_floating_point())
        for key, val in stack["pm"].state_dict().items():
            assert torch.equal(svc._model.state_dict()[key], val), key
        clip = _clips(6, 1)[0]
        out = svc.submit(clip).result(timeout=120)
    finally:
        svc.close()
    with _live(stack, seed=4) as live:
        np.testing.assert_array_equal(out, live.submit(clip).result(timeout=120))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_clis_end_to_end(stack, tmp_path):
    """export_rollout's main() from a port checkpoint, then serve_http's
    CLI in its own process on the artifact, queried over HTTP with a
    bearer token from WMZ_SERVE_TOKEN, stopped with SIGINT."""
    out = str(tmp_path / "artifact")
    export_rollout.main(["--checkpoint", stack["ckpt"], "--out", out,
                         "--platform", "cpu", "--num_frames", str(FRAMES),
                         "--num_iterations", "2", "--batch_size", "2"])
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert meta["sizes"] == [1, 2] and meta["num_iterations"] == 2
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "world_modelz_tpu_torch.cli.serve_http",
         "--platform", "cpu", "--exported", out, "--port", str(port),
         "--max_wait_s", "0.01"],
        cwd=REPO, env=dict(os.environ, WMZ_SERVE_TOKEN="tok3n"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
                    assert json.loads(r.read()) == {"ok": True}
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        got = http_generate(url, _clips(7, 1)[0], timeout=120, token="tok3n")
        assert got.shape == (FRAMES, IMG, IMG, C) and np.isfinite(got).all()
    finally:
        proc.send_signal(2)  # SIGINT: the CLI shuts the server down
        text = proc.communicate(timeout=60)[0]
    assert proc.returncode == 0, text
    assert f"serving step-aot:{out} checkpoint on {url}" in text


def test_entry_points_raise_without_a_gpu(stack, artifact, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        aot.AOTPrograms.load(artifact)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.build_service(serve_cli.ServeHTTPConfig(exported=artifact))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_rollout.run(export_rollout.ExportRolloutConfig(
            checkpoint=stack["ckpt"], out=str(tmp_path)))
