"""Port: the trainers' fused dispatch (``--steps_per_dispatch``,
``world_modelz_tpu_torch.train.dispatch``) on the CPU.

On the CPU the step program runs eagerly; on the card the same function is
captured as a CUDA graph (``chip_smoke.py`` holds replays to eager steps
there). These tests hold the dispatch loop to the JAX trainers'
(tests/test_cli_smoke.py:64-99 and :224-250): with k = 3 (video) and k = 4
(sparse, ``change_batch_interval`` 3) and ``max_steps`` 7 the log points
are steps [1, 2, 4, 6] and the checkpoints land at JAX's steps; k = 3 and
k = 1 give bitwise the same losses, parameters, optimizer state, EMA and
sampler state; a non-finite step inside a dispatch leaves the state
bitwise as it was; a restore writes into the state's tensors in place, so
a step after it equals an eager step from the restored state. Everything
compared here is bitwise: one function, the same draws, on one device.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.models import VQAutoEncoder  # noqa: E402
from world_modelz_tpu_torch.train.dispatch import (  # noqa: E402
    dispatch_len,
    run_dispatch,
    step_inputs,
)
from world_modelz_tpu_torch.train.timing import TrainTiming  # noqa: E402

S, IMG = 3, 16
VIDEO_TOK = dict(embedding_dim=8, num_embeddings=16, downscale_steps=2,
                 hidden_planes=8, in_channels=1)
SPARSE_TOK = dict(VIDEO_TOK, in_channels=3)


def _tok(tmp_path_factory, cfg):
    torch.manual_seed(0)
    tok = VQAutoEncoder(**cfg, device="cpu")
    return ptrain.save_checkpoint(
        str(tmp_path_factory.mktemp("tok")), 0, {"tokenizer": tok.state_dict()}, cfg)


@pytest.fixture(scope="module")
def video_tok(tmp_path_factory):
    return _tok(tmp_path_factory, VIDEO_TOK)


@pytest.fixture(scope="module")
def sparse_tok(tmp_path_factory):
    return _tok(tmp_path_factory, SPARSE_TOK)


def _video(tok_path, out, **kw):
    base = dict(
        platform="cpu", decoder_model=tok_path, output_dir=str(out), name="vdk",
        batch_size=2, n_past=S - 1, image_size=IMG, digit_size=6, dim=32,
        depth=2, mlp_dim=24, dim_head=16, heads=2, extents=(1, 1, 1),
        warmup=2, max_steps=7, steps_per_dispatch=3, eval_interval=0,
        checkpoint_interval=4, log_interval=2, histogram_interval=0,
        ema_decay=0.9, bf16=True)
    base.update(kw)
    return vd.VideoDiffusionConfig(**base)


def _sparse(tok_path, out, **kw):
    base = dict(
        platform="cpu", decoder_model=tok_path, output_dir=str(out), name="sdk",
        image_size=IMG, S=4, H=4, W=4, num_context=24, batch_size=2,
        eval_batch_size=1, dim=32, heads=2, depth=2, mlp_dim=24, warmup=2,
        max_steps=7, steps_per_dispatch=4, change_batch_interval=3,
        eval_interval=0, checkpoint_interval=6, histogram_interval=0,
        log_interval=2, ema_decay=0.9, bf16=True, buffer_size=60,
        max_segment_length=60)
    base.update(kw)
    return sd.SparseDiffusionConfig(**base)


def _logged(path):
    with open(path) as f:
        return [r["step"] for r in map(json.loads, f) if "loss" in r]


def _bits(t):
    t = t.detach().contiguous()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _assert_states_bitwise(a, b):
    """Parameters, Adam's moments and count, the EMA and the sampler."""
    for x, y in zip(a.tensors(), b.tensors()):
        assert torch.equal(_bits(x), _bits(y))
    for (n, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(_bits(x), _bits(y)), n


def test_dispatch_len_stops_at_every_boundary():
    # k = 3 from 0 with a first log point at 1, log every 2, checkpoints
    # every 4, max 7: the video trainer's dispatches of the smoke test
    runs, done = [], 0
    while done < 7:
        n = dispatch_len(done, 3, 7, 1, (2, 0, 4, 0, 0))
        runs.append(n)
        done += n
    assert runs == [1, 1, 2, 2, 1]
    assert dispatch_len(0, 10, 60, 1, (10, 0, 60, 0, 0)) == 1
    assert dispatch_len(1, 10, 60, 1, (10, 0, 60, 0, 0)) == 9
    assert dispatch_len(10, 10, 60, 1, (10, 0, 60, 0, 0)) == 10
    # a probe interval and a batch refresh end dispatches too
    assert dispatch_len(20, 10, 60, 1, (10, 0, 60, 0, 25)) == 5
    assert dispatch_len(4, 4, 60, 1, (10, 0, 0, 0, 0, 3)) == 2


def test_video_trainer_fused_dispatch_boundaries_and_resume(video_tok, tmp_path):
    """tests/test_cli_smoke.py:64-99 on the port."""
    cfg = _video(video_tok, tmp_path)
    result = vd.train(cfg)
    assert os.path.isdir(os.path.join(str(tmp_path), "step_0000004"))
    assert _logged(os.path.join(str(tmp_path), "vdk_metrics.jsonl")) == [1, 2, 4, 6]
    assert [h[0] for h in result.history] == list(range(1, 8))
    resumed = vd.train(dataclasses.replace(
        cfg, checkpoint=os.path.join(str(tmp_path), "step_0000004"), max_steps=10))
    assert os.path.isdir(os.path.join(str(tmp_path), "step_0000008"))
    assert [h[0] for h in resumed.history] == [5, 6, 7, 8, 9, 10]


def test_sparse_trainer_fused_dispatch_boundaries(sparse_tok, tmp_path):
    """tests/test_cli_smoke.py:224-250 on the port: dispatches end at the
    batch refresh (steps = 1 mod change_batch_interval) too."""
    result = sd.train(_sparse(sparse_tok, tmp_path))
    assert os.path.isdir(os.path.join(str(tmp_path), "step_0000006"))
    assert _logged(os.path.join(str(tmp_path), "sdk_metrics.jsonl")) == [1, 2, 4, 6]
    assert [h[0] for h in result.history] == list(range(1, 8))


@pytest.mark.parametrize("trainer", ["video", "sparse"])
def test_k3_equals_k1_bitwise(video_tok, sparse_tok, tmp_path, trainer):
    if trainer == "video":
        runs = [vd.train(_video(video_tok, tmp_path / str(k), steps_per_dispatch=k))
                for k in (1, 3)]
    else:
        runs = [sd.train(_sparse(sparse_tok, tmp_path / str(k), steps_per_dispatch=k))
                for k in (1, 3)]
    one, three = runs
    assert [h[:4] for h in one.history] == [h[:4] for h in three.history]
    assert all(h[3] for h in one.history)
    _assert_states_bitwise(one.state, three.state)
    assert one.state.step == three.state.step == 7


def _video_state(tok_path, **kw):
    """A trainer's pieces for driving the step program by hand: config,
    tokenizer, state, clip source."""
    cfg = _video(tok_path, "unused", **kw)
    tok, _ = vd.load_tokenizer(tok_path, "cpu")
    vd.tokenizer_inference_cast(tok)
    torch.manual_seed(1)
    model = vd.make_model(cfg, (S, 4, 4), tok.num_embeddings, "cpu")
    state = vd.init_state(cfg, model)
    clip_fn, _ = vd.build_clip_fn(cfg, 5)
    return cfg, tok, state, clip_fn


def _program(cfg, tok, state, k):
    io = step_inputs({"frames": torch.zeros((cfg.batch_size, S, IMG, IMG, 1),
                                            dtype=torch.uint8)},
                     vd.StepDraws.empty(cfg.batch_size, 16, 100, "cpu"), k)
    program = vd.step_program(state, io, lambda: vd.step_body(
        state, tok, io.tensors["frames"], cfg, io.draws))
    return io, program


def _feed(io, frames, gen, cfg, before=None):
    def feed():
        if before is not None:
            before()
        io.tensors["frames"].copy_(frames)
        vd.draw_step(gen, cfg.batch_size, 16, 100, 16, out=io.draws)
    return feed


def test_a_nonfinite_step_inside_a_dispatch_leaves_the_state_unchanged(video_tok):
    """Three steps in one dispatch, the second made non-finite (an inf
    bias); the state after the dispatch equals eager steps 1 and 3 with the
    second step's draws skipped, and its row says ok = False."""
    cfg, tok, state, clip_fn = _video_state(video_tok)
    ref_cfg, _, ref, _ = _video_state(video_tok)
    frames = [torch.from_numpy(clip_fn(cfg.batch_size)) for _ in range(3)]
    bias = state.model.logit_proj.bias
    saved = bias.detach().clone()

    def poison():
        with torch.no_grad():
            bias[0] = float("inf")

    def heal():
        with torch.no_grad():
            bias.copy_(saved)

    gen = torch.Generator().manual_seed(2)
    io, program = _program(cfg, tok, state, 3)
    rows = run_dispatch(program, io, TrainTiming(), 0, [
        _feed(io, frames[0], gen, cfg),
        _feed(io, frames[1], gen, cfg, before=lambda: (saved.copy_(bias.detach()), poison())),
        _feed(io, frames[2], gen, cfg, before=heal)], frames[-1], set())
    assert [r[2] for r in rows] == [True, False, True]
    assert not np.isfinite(rows[1][0])

    gen = torch.Generator().manual_seed(2)
    want = []
    for i, f in enumerate(frames):
        draws = vd.draw_step(gen, cfg.batch_size, 16, 100, 16)
        if i != 1:
            want.append(vd.train_step(ref, tok, f, ref_cfg, draws))
    assert [(r[0], r[1]) for r in (rows[0], rows[2])] == [(w[0], w[1]) for w in want]
    _assert_states_bitwise(state, ref)


def test_a_restore_writes_in_place_and_the_next_step_is_an_eager_step(video_tok, tmp_path):
    cfg, tok, state, clip_fn = _video_state(video_tok)
    gen = torch.Generator().manual_seed(3)
    io, program = _program(cfg, tok, state, 1)
    frames = [torch.from_numpy(clip_fn(cfg.batch_size)) for _ in range(4)]

    def step(f):
        return run_dispatch(program, io, TrainTiming(), 0, [_feed(io, f, gen, cfg)],
                            f, set())[0]

    step(frames[0])
    path = ptrain.save_checkpoint(str(tmp_path), 1, state.state_dict())
    step(frames[1])
    step(frames[2])
    addresses = [t.data_ptr() for t in state.tensors()]
    restored, at, _ = ptrain.restore_checkpoint(path)
    state.load_state_dict(restored, at)
    assert [t.data_ptr() for t in state.tensors()] == addresses
    after = step(frames[3])

    _, _, ref, _ = _video_state(video_tok)
    ref.load_state_dict(ptrain.restore_checkpoint(path)[0], 1)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):  # the draws the three steps above consumed
        vd.draw_step(gen, cfg.batch_size, 16, 100, 16)
    want = vd.train_step(ref, tok, frames[3], cfg, vd.draw_step(gen, cfg.batch_size, 16, 100, 16))
    assert after == want
    _assert_states_bitwise(state, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_gradient_is_the_scatter_sum(dtype):
    """The models' ``Embedding``: nn.Embedding's forward and weight
    gradient (the same sums, summed by a one-hot product in a fixed
    order), also for a bf16 weight under functional_call as the trainers'
    bf16 forward passes it."""
    from world_modelz_tpu_torch.models.attention import Embedding

    torch.manual_seed(0)
    e = Embedding(13, 6)
    ref = torch.nn.Embedding(13, 6)
    ref.load_state_dict(e.state_dict())
    idx = torch.randint(0, 13, (4, 50))
    g = torch.randn(4, 50, 6).to(dtype)
    w = e.weight.detach().to(dtype).requires_grad_()
    w_ref = ref.weight.detach().to(dtype).requires_grad_()
    out = torch.func.functional_call(e, {"weight": w}, (idx,))
    want = torch.func.functional_call(ref, {"weight": w_ref}, (idx,))
    assert torch.equal(out, want)
    out.backward(g)
    want.backward(g)
    assert w.grad.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7 * float(w_ref.grad.abs().max())
    torch.testing.assert_close(w.grad.float(), w_ref.grad.float(), rtol=0, atol=tol)


def test_stats_rows_wrap_for_the_capture_warm_up():
    """A capture warms its step up twice before capturing it, so a k = 1
    program records three steps from one ``start``: the row wraps."""
    io = step_inputs({"x": torch.zeros(2)}, None, 1)
    for i in range(3):
        io.record(torch.tensor([float(i), 1.0, 1.0]))
    assert io.read(1) == [(2.0, 1.0, True)] and int(io.row) == 0
    io = step_inputs({"x": torch.zeros(2)}, None, 3)
    io.start()
    for i in range(3):
        io.record(torch.tensor([float(i), 0.5, 0.0]))
    assert io.read(3) == [(0.0, 0.5, False), (1.0, 0.5, False), (2.0, 0.5, False)]
