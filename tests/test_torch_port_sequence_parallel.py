"""The port's sequence axis (``parallel.sequence``: the halo exchange,
``local3d_attention_seq``, ``seq_sharded_attention``; the video trainer
under ``--n_seq``) against the JAX package and against one process.

``local3d_attention_seq``'s per-rank math (halos sliced from the whole
clip and passed in, the shards stitched in this process) and the
exchanged version (each rank of a spawned world of four gloo processes its
own shard, halos by ``ppermute``) are held to JAX's
``make_seq_sharded_attention`` run jitted on the 8 host devices of
conftest.py: values and q/k/v gradients at extents (1,1,1), (2,1,0) and
(0,1,1), S=8 over 2 and 4 shards, within rtol 2e-4, atol 2e-5 (the JAX
test's own, tests/test_sequence_parallel.py:35-37). In bf16 the per-rank
math keeps JAX's rounding point for P (normalised, then rounded); its
backward rounds P and dS before their products where JAX's einsum
autodiff rounds the stacked products instead, so values and gradients are
held within 2^-6 x max |x|.

The train steps, each rank its rows and its frames of the global batch,
must equal the port's world-1 step on that batch within the data axis
tests' tolerance (tests/test_torch_port_data_parallel.py), 1e-6 x max(1,
max |x|), sampler counts exact: the video step, two layers deep (so the
last frame sees every shard), at data=2 x seq=2 and at seq=2 x model=2.
The world is joined with a timeout of 120 s and imports no JAX.
"""

import os
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_data_parallel import (  # noqa: E402
    TOK_CFG,
    _close,
    _flat,
    _free_port,
    _one_process,
    _video_cfg,
)
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer  # noqa: E402
from world_modelz_tpu_torch.models import VQAutoEncoder  # noqa: E402
from world_modelz_tpu_torch.parallel import distributed as pdist  # noqa: E402
from world_modelz_tpu_torch.parallel import sequence as pseq  # noqa: E402
from world_modelz_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from world_modelz_tpu_torch.train import save_checkpoint  # noqa: E402

WORLD, B, JOIN_S = 4, 4, 120
EXTENTS = [(1, 1, 1), (2, 1, 0), (0, 1, 1)]
HEADS, SHAPE = 2, (2, 8, 4, 4, 8)  # (B, S, H, W, heads * dh)
STEPS = {"video_seq": dict(n_seq=2), "video_seq_tp": dict(n_seq=2, n_model=2)}


def _qkvg(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=SHAPE).astype(np.float32) for _ in range(4)]


def _stitched(arrays, extents, n, dtype=torch.float32):
    """The per-rank math of ``n`` shards in one process: each shard's halos
    cut from the whole K and V; values and q/k/v gradients of
    sum(out * g), in f32."""
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays[:3])
    es, s_loc = extents[0], SHAPE[1] // n
    outs = []
    for i in range(n):
        lo, hi = i * s_loc, (i + 1) * s_loc
        left = right = None
        if es and i > 0:
            left = (k[:, lo - es:lo], v[:, lo - es:lo])
        if es and i < n - 1:
            right = (k[:, hi:hi + es], v[:, hi:hi + es])
        outs.append(pseq.local3d_attention_seq(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                                               extents, HEADS, left, right))
    out = torch.cat(outs, 1)
    (out.float() * torch.from_numpy(arrays[3])).sum().backward()
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad, v.grad)]


def _jax_seq(arrays, extents, n, dtype="float32"):
    """JAX's sharded attention over ``n`` devices: values and q/k/v
    gradients of sum(out * g)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

    from world_modelz_tpu.parallel.sequence import make_seq_sharded_attention

    mesh = JMesh(np.array(jax.devices()[:n]), ("data",))
    fn = make_seq_sharded_attention(mesh, extents=extents, heads=HEADS, global_seq=SHAPE[1])
    sh = NamedSharding(mesh, P(None, "data"))
    q, k, v = (jax.device_put(jnp.asarray(a, dtype), sh) for a in arrays[:3])
    g = jnp.asarray(arrays[3])

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * g)

    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(t, np.float32) for t in (out, *grads)]


def _run_steps(case, tok_path, mesh):
    """Two video steps on the global batches of their seeds: this rank's
    rows and frames of each."""
    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(2)
    # depth 2: the last frame's receptive field reaches every shard's frames
    cfg = _video_cfg(tok_path, n_past=3, depth=2)
    tok, _ = load_tokenizer(tok_path, "cpu")
    state = vd.init_state(cfg, vd.make_model(cfg, (4, 4, 4), 16, "cpu"), mesh)
    rows = []
    for _ in range(2):
        clips = torch.from_numpy(rng.integers(0, 256, (B, 4, 16, 16, 1), dtype=np.uint8))
        draws = vd.draw_step(gen, B, 16, state.sampler.weights.shape[0], 16)
        local = pdist.shard_host_batch(clips, mesh)
        rows.append(vd.step_body(state, tok, {"frames": local}, cfg, draws).tolist())
    return _flat(state.state_dict()), rows


def _exchanged(mesh, extents):
    """This rank's shard of the exchanged attention: its output and its
    q/k/v gradients."""
    arrays = _qkvg()
    s_loc = SHAPE[1] // mesh.n_seq
    lo, hi = mesh.seq * s_loc, (mesh.seq + 1) * s_loc
    q, k, v = (torch.from_numpy(a[:, lo:hi].copy()).requires_grad_(True) for a in arrays[:3])
    out = pseq.seq_sharded_attention(q, k, v, extents, HEADS, mesh.axis("seq"))
    (out * torch.from_numpy(arrays[3][:, lo:hi].copy())).sum().backward()
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


def _scenarios(rank, root, tok_path):
    out = {}
    for n in (2, 4):
        mesh = make_mesh(n_seq=n)
        for extents in EXTENTS:
            out[("exchanged", n, extents)] = (mesh.seq, _exchanged(mesh, extents))
    for case, axes in STEPS.items():
        out[case] = _run_steps(case, tok_path, make_mesh(**axes))
    return out


def _worker(rank, port, root, tok_path):
    torch.set_num_threads(1)
    try:
        assert pdist.initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
        out = _scenarios(rank, root, tok_path)
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(root, f"world_{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seq"))
    torch.manual_seed(0)
    tok = VQAutoEncoder(**TOK_CFG, device="cpu")
    tok_path = save_checkpoint(os.path.join(root, "tok"), 0, {"tokenizer": tok.state_dict()},
                               dict(TOK_CFG))
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, root, tok_path))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not hung, f"processes {hung} still running after {JOIN_S} s"
    outs = [torch.load(os.path.join(root, f"world_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    for out in outs:
        assert "error" not in out, out.get("error")
    assert [p.exitcode for p in procs] == [0] * WORLD
    return tok_path, outs


def _assert_parity(got, want, names=("out", "dq", "dk", "dv")):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("extents", EXTENTS)
def test_per_rank_math_matches_jax(n, extents):
    arrays = _qkvg()
    _assert_parity(_stitched(arrays, extents, n), _jax_seq(arrays, extents, n))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("extents", EXTENTS)
def test_exchanged_shards_match_jax(runs, n, extents):
    _, outs = runs
    want = _jax_seq(_qkvg(), extents, n)
    s_loc = SHAPE[1] // n
    for out in outs:
        seq, got = out[("exchanged", n, extents)]
        _assert_parity(got, [w[:, seq * s_loc:(seq + 1) * s_loc] for w in want])


def test_bf16_per_rank_math_keeps_jax_rounding_point():
    arrays = _qkvg(1)
    got = _stitched(arrays, (1, 1, 1), 4, torch.bfloat16)
    want = _jax_seq(arrays, (1, 1, 1), 4, "bfloat16")
    for g, w, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=0, atol=2.0**-6 * np.abs(w).max(),
                                   err_msg=name)


def test_extent_beyond_the_shard_raises():
    x = torch.zeros((1, 1, 2, 2, 4))
    with pytest.raises(ValueError, match="exceeds the local shard"):
        pseq.local3d_attention_seq(x, x, x, (3, 1, 1), 1)
    with pytest.raises(ValueError, match="exceeds the local shard"):
        pseq.seq_sharded_attention(x, x, x, (3, 1, 1), 1, Mesh().axis("seq"))


@pytest.mark.parametrize("case", list(STEPS))
def test_seq_axis_step_equals_world1_step(runs, case):
    tok_path, outs = runs
    got, got_rows = outs[0][case]
    want, want_rows = _one_process(lambda: _run_steps(case, tok_path, Mesh()))
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith(("sampler.counts", ".count")):
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        else:
            _close(got[name], w, err=name)
    _close(got_rows, want_rows)
    assert [r[2] for r in got_rows] == [1.0, 1.0]
    for out in outs[1:]:  # the loss, the sampler and the state on every rank
        np.testing.assert_array_equal(out[case][1], got_rows)
        for name, w in got.items():
            np.testing.assert_array_equal(out[case][0][name], w, err_msg=name)


def test_video_trainer_refuses_what_jax_refuses(tmp_path):
    for kw, msg in ((dict(n_past=4, n_seq=2), r"n_past\+1 \(5 frames\) must be divisible by "
                     r"n_seq \(2\)"),
                    (dict(n_past=3, n_seq=4, extents=(2, 1, 1)),
                     "sequence shards of 1 frames are shorter than the temporal extent 2")):
        with pytest.raises(ValueError, match=msg):
            vd.check_supported(_video_cfg(str(tmp_path), **kw))
