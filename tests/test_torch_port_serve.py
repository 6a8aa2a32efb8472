"""Port parity: the serving slice (``world_modelz_tpu_torch.diffusion`` and
``world_modelz_tpu_torch.serve``) against the JAX package, and the port's
boundaries.

The JAX sampler draws its Gumbel noise and re-mask uniforms from a key-split
sequence (diffusion/masked.py: one split per frame, three per iteration);
the tests replay those draws into the port's sampler, so the same weights
must give the same tokens. Pixels after decode agree within 1e-4 (f32
convolutions summed in another order).
"""

import ast
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.diffusion import masked as jmasked  # noqa: E402
from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.models.video import (  # noqa: E402
    VqVideoDiffusionModel as JaxDenoiser,
)
from world_modelz_tpu.serve import RolloutService as JaxService  # noqa: E402
from world_modelz_tpu.serve import rolled_context as jax_rolled  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.diffusion import (  # noqa: E402
    rollout_frames,
    top_k_logits,
)
from world_modelz_tpu_torch.diffusion.masked import generator_noise  # noqa: E402
from world_modelz_tpu_torch.models import (  # noqa: E402
    VQAutoEncoder,
    VqVideoDiffusionModel,
)
from world_modelz_tpu_torch.serve import RolloutService, rolled_context  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "world_modelz_tpu_torch")
S, IMG, C, K, D = 3, 16, 1, 16, 8
TH = IMG // 4
PIX_TOL = 1e-4


@pytest.fixture(scope="module")
def stack():
    """JAX tokenizer + denoiser and the port's, on the same weights."""
    key = jax.random.PRNGKey(0)
    jtok = JaxTokenizer(
        embedding_dim=D, num_embeddings=K, downscale_steps=2,
        hidden_planes=8, in_channels=C,
    )
    tok_state = jtok.init(key, jnp.zeros((1, IMG, IMG, C)))
    jm = JaxDenoiser(
        data_shape=(S, TH, TH), dim=16, num_classes=K, extents=(1, 1, 1),
        depth=2, dim_head=8, mlp_dim=16, heads=2, backend="xla",
    )
    params = jm.init(key, jnp.zeros((1, S, TH, TH), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)

    ptok = VQAutoEncoder(D, K, 2, 8, C, device="cpu")
    ptok.load_state_dict(convert.tokenizer_state_dict_from_state(
        tok_state.params, tok_state.batch_stats,
        np.asarray(tok_state.vq.codebook),
    ), strict=True)
    pm = VqVideoDiffusionModel(
        (S, TH, TH), 16, K, (1, 1, 1), 2, 8, 16, heads=2, device="cpu")
    pm.load_state_dict(convert.video_state_dict_from_params(params), strict=True)
    return jtok, tok_state, jm, params, ptok, pm


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


@pytest.mark.parametrize("sample_topk", [-1, 4])
def test_rollout_tokens_match_jax_under_its_noise(stack, sample_topk):
    _, _, jm, params, _, pm = stack
    ctx = np.random.default_rng(0).integers(
        0, K, size=(2, S, TH, TH)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    kw = dict(num_frames=2, num_classes=K, mask_token=K, num_iterations=4,
              sample_topk=sample_topk)
    ref = np.asarray(jmasked.rollout_frames(
        key, lambda z: jm.apply({"params": params}, z), jnp.asarray(ctx), **kw))
    with torch.no_grad():
        got = rollout_frames(
            pm, torch.from_numpy(ctx), noise=_jax_draws(key, 2, 4, 2), **kw)
    assert tuple(got.shape) == ref.shape == (2, 2, TH, TH)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_slice_matches_jax_service_programs(stack):
    """Encode -> rollout -> decode, as the JAX RolloutService's two programs
    (serve.py:185-209) run it, on the same weights and the same draws."""
    jtok, tok_state, jm, params, ptok, pm = stack
    seeds = np.random.default_rng(1).uniform(
        size=(2, S, IMG, IMG, C)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jsvc = JaxService(jtok, tok_state, jm, params, num_frames=2,
                      num_iterations=3, batch_size=2)
    try:
        ref_tokens = np.asarray(jsvc._encode_call(jnp.asarray(seeds)))
        ref_pix, ref_ctx = (np.asarray(a) for a in
                            jsvc._rollout_call(jnp.asarray(ref_tokens), key))
    finally:
        jsvc.close()

    tokens = ptok.encode(torch.from_numpy(seeds).reshape(2 * S, IMG, IMG, C))
    tokens = tokens.reshape(2, S, TH, TH)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    with torch.no_grad():
        gen = rollout_frames(
            pm, tokens, num_frames=2, num_classes=K, mask_token=K,
            num_iterations=3, noise=_jax_draws(key, 2, 3, 2))
    pix = ptok.decode(gen.reshape(4, TH, TH)).reshape(2, 2, IMG, IMG, C)
    np.testing.assert_allclose(pix.numpy(), ref_pix, atol=PIX_TOL, rtol=0)
    np.testing.assert_array_equal(rolled_context(tokens, gen).numpy(), ref_ctx)


def test_top_k_logits_matches_jax():
    logits = np.random.default_rng(2).normal(size=(3, 5, 10)).astype(np.float32)
    ref = np.asarray(jmasked.top_k_logits(jnp.asarray(logits), 3))
    got = top_k_logits(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_default_sampler_draws_softmax_frequencies():
    """argmax(logits + Gumbel) from the port's torch.Generator noise is a
    draw from softmax(logits): chi-square over 20,000 draws at a fixed seed,
    against the 0.1% critical value of chi2 with 5 degrees of freedom
    (20.52); the re-mask uniforms lie in [0, 1) with mean near 1/2."""
    logits = torch.tensor([0.0, 0.5, 1.0, -1.0, 2.0, 0.3])
    n = 20_000
    gen = torch.Generator().manual_seed(11)
    gumbel, uniform = generator_noise(gen, (n, 1, 1), 6)(0, 0)
    draws = (logits + gumbel.reshape(n, 6)).argmax(-1)
    observed = torch.bincount(draws, minlength=6).double()
    expected = torch.softmax(logits.double(), 0) * n
    chi2 = float(((observed - expected) ** 2 / expected).sum())
    assert chi2 < 20.52, chi2
    assert 0.0 <= float(uniform.min()) and float(uniform.max()) < 1.0
    assert abs(float(uniform.mean()) - 0.5) < 0.02


def test_rolled_context_matches_jax():
    tokens = np.arange(2 * 4 * 2 * 2).reshape(2, 4, 2, 2)
    gen = 100 + np.arange(2 * 3 * 2 * 2).reshape(2, 3, 2, 2)
    ref = np.asarray(jax_rolled(jnp.asarray(tokens), jnp.asarray(gen)))
    got = rolled_context(torch.from_numpy(tokens), torch.from_numpy(gen))
    np.testing.assert_array_equal(got.numpy(), ref)
    one = torch.from_numpy(tokens[:, :1])
    assert torch.equal(rolled_context(one, torch.from_numpy(gen)), one)


def _service(stack, **kw):
    *_, ptok, pm = stack
    kw.setdefault("num_frames", 2)
    kw.setdefault("num_iterations", 2)
    kw.setdefault("batch_size", 4)
    return RolloutService(ptok, pm, device="cpu", **kw)


def _clip(rng):
    return rng.uniform(size=(S, IMG, IMG, C)).astype(np.float32)


def test_cpu_service_coalesces_concurrent_submits_and_streams(stack):
    """3 concurrent submits coalesce into one ladder-size-4 batch with one
    padded row; a session encodes once and continues its context."""
    rng = np.random.default_rng(4)
    clips = [_clip(rng) for _ in range(3)]
    results = {}
    with _service(stack, max_wait_s=0.5) as svc:
        assert svc._sizes == [1, 2, 4]

        def client(i):
            results[i] = svc.submit(clips[i]).result(timeout=120)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert svc.stats["batches"] == 1
        assert svc.stats["batched_rows"] == 4
        assert svc.stats["padded_rows"] == 1
        assert svc.stats["encode_calls"] == 1

        sess = svc.open_session(clips[0])
        ctx0 = np.array(sess._ctx)
        a = sess.generate()
        ctx1 = np.array(sess._ctx)
        b = sess.generate()
    assert set(results) == {0, 1, 2}
    for out in (*results.values(), a, b):
        assert out.shape == (2, IMG, IMG, C) and np.isfinite(out).all()
    assert svc.stats["requests"] == 5
    assert svc.stats["batches"] == 3
    assert svc.stats["encoded_clips"] == 4  # 3 submits + 1 session seed
    assert svc.stats["session_rows"] == 2
    assert ctx0.shape == ctx1.shape and not np.array_equal(ctx0, ctx1)
    np.testing.assert_array_equal(ctx0[-1], ctx1[-1])  # generation slot


def test_cpu_service_ladder_and_deadline(stack):
    """A lone request runs at ladder size 1; a request whose queue deadline
    passed is shed and never takes a batch row."""
    rng = np.random.default_rng(5)
    clip = _clip(rng)
    with _service(stack, max_wait_s=0.01) as svc:
        svc.submit(clip).result(timeout=120)
        assert (svc.stats["batched_rows"], svc.stats["padded_rows"]) == (1, 0)
        gate = svc.submit(clip)
        expired = svc.submit(clip, timeout_s=0.0)
        live = svc.submit(clip)
        with pytest.raises(TimeoutError):
            expired.result(timeout=120)
        assert live.result(timeout=120).shape == (2, IMG, IMG, C)
        assert gate.result(timeout=120).shape == (2, IMG, IMG, C)
    assert svc.stats["expired"] == 1
    assert svc.stats["requests"] == 3
    with pytest.raises(RuntimeError):
        svc.submit(clip)


def test_entry_points_default_to_cuda_and_raise_without_it(stack, monkeypatch):
    *_, ptok, pm = stack
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RolloutService(ptok, pm, num_frames=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VQAutoEncoder(D, K, 2, 8, C)


def _port_modules():
    names = []
    for root, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                name = rel.replace(os.sep, ".")
                names.append(name[: -len(".__init__")]
                             if name.endswith(".__init__") else name)
    return sorted(names)


def test_port_imports_with_jax_and_the_jax_package_blocked():
    names = _port_modules()
    assert "world_modelz_tpu_torch.serve" in names and len(names) >= 15
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'world_modelz_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_and_chip_smoke_never_name_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, fs in os.walk(PORT):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    banned = {"jax", "jaxlib", "flax", "optax", "world_modelz_tpu"}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            elif isinstance(node, ast.Name):
                mods = [node.id]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, (path, mod)
