"""The port's data axis (``parallel.distributed``, ``parallel.mesh``,
``parallel.fsdp``) in two gloo processes on the CPU, against one process.

The JAX package's data parallelism is global-view: a step on W data shards
is the step on the whole batch. So a world-2 step, each rank given its rows
of a global batch and the global batch's draws, must equal the world-1 step
on that batch: the video step, the sparse step (dense and with two experts,
whose load-balance means cross the ranks) and the tokenizer step (BatchNorm
moments and the quantizer's per-code statistics across the ranks, with the
plain ``vq_apply`` and the fused statistics' plain version). Parameters,
EMA, Adam's moments, BatchNorm and VQ statistics within 1e-6 x max(1,
max |x|) (f32 sums split over two ranks), the decoder biases that
BatchNorm cancels (exact gradient 0) within 2 lr a step, as
tests/test_torch_port_tokenizer_train.py holds them; sampler counts exact.
The tokenizer's world-1 step runs in a gloo group of one, so its BatchNorm
takes the same two-pass moments as the world-2 step;
tests/test_torch_port_tokenizer_train.py holds that group-of-one step to
the JAX step. The sparse trainer with two experts, evaluating
after every step on rank 0 alone, runs to its end with the ranks' weights
equal: its sampling issues no collective. ``--fsdp``
(reduce-scattered gradients, sharded state) equals replicated data
parallelism within the same tolerance, its gathered checkpoints resume a
replicated run and the other way round, and ``--shard_batch`` rolls out
the unsharded pixels.

Port only: nothing here imports JAX, and the two processes import this
module (spawned). The processes are joined with a timeout of 120 s, so a
hang fails the test instead of holding the suite.
"""

import dataclasses
import json
import os
import socket
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu_torch.cli import rollout as ro  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.cli import train_vqae as tv  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer  # noqa: E402
from world_modelz_tpu_torch.models import VQAutoEncoder  # noqa: E402
from world_modelz_tpu_torch.parallel import distributed as pdist  # noqa: E402
from world_modelz_tpu_torch.parallel.mesh import Mesh, check_batch, make_mesh  # noqa: E402
from world_modelz_tpu_torch.train import restore_checkpoint, save_checkpoint  # noqa: E402

WORLD, B, TOL, JOIN_S = 2, 4, 1e-6, 120
TOK_CFG = dict(embedding_dim=8, num_embeddings=16, downscale_steps=2, hidden_planes=8,
               in_channels=1)
TOK3_CFG = dict(TOK_CFG, in_channels=3)  # the sparse trainer's RGB frames
STEP_CASES = ["video", "video_fsdp", "sparse", "sparse_fsdp", "sparse_moe",
              "tokenizer_xla", "tokenizer_fused"]


def _video_cfg(tok_path, **kw):
    base = dict(platform="cpu", decoder_model=tok_path, batch_size=B, n_past=2,
                image_size=16, digit_size=6, dim=32, depth=1, mlp_dim=24, dim_head=16,
                heads=2, extents=(1, 1, 1), warmup=1, max_steps=10, ema_decay=0.9,
                eval_interval=0, log_interval=1, tok_bf16=False)
    base.update(kw)
    return vd.VideoDiffusionConfig(**base)


def _sparse_cfg(**kw):
    base = dict(platform="cpu", S=4, H=4, W=4, num_context=24, batch_size=B, dim=32,
                heads=2, depth=1, mlp_dim=24, warmup=1, max_steps=10, ema_decay=0.9)
    base.update(kw)
    return sd.SparseDiffusionConfig(**base)


def _tok_cfg(**kw):
    return tv.TrainVqaeConfig(**dict(TOK_CFG, platform="cpu", batch_size=B, image_size=16,
                                     **kw))


def _flat(state_dict):
    """A nest of tensors -> {dotted name: numpy array}."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}.{k}" if prefix else k, x)
        elif isinstance(v, torch.Tensor):
            out[prefix] = v.detach().cpu().numpy().copy()

    walk("", state_dict)
    return out


def _run_steps(case, tok_path, mesh):
    """Two steps of ``case`` on the global batches of its seeds, this rank's
    rows of each; returns the state's whole tensors and the steps' rows."""
    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(2)
    rows = []
    if case.startswith("video"):
        cfg = _video_cfg(tok_path, fsdp=case.endswith("fsdp"))
        tok, _ = load_tokenizer(tok_path, "cpu")
        state = vd.init_state(cfg, vd.make_model(cfg, (3, 4, 4), 16, "cpu"), mesh)
        for _ in range(2):
            clips = torch.from_numpy(rng.integers(0, 256, (B, 3, 16, 16, 1), dtype=np.uint8))
            draws = vd.draw_step(gen, B, 16, state.sampler.weights.shape[0], 16)
            local = pdist.shard_host_batch(clips, mesh)
            rows.append(vd.step_body(state, tok, {"frames": local}, cfg, draws).tolist())
        return _flat(state.state_dict()), rows
    if case.startswith("sparse"):
        cfg = _sparse_cfg(fsdp=case.endswith("fsdp"),
                          **(dict(moe_experts=2, moe_capacity_factor=1.0)
                             if case.endswith("moe") else {}))
        state = sd.init_state(cfg, sd.make_model(cfg, 16, "cpu"), mesh)
        for _ in range(2):
            batch_z = torch.from_numpy(rng.integers(0, 16, (B, 4, 4, 4)))
            draws = sd.draw_step(gen, B, 24, 64, state.sampler.weights.shape[0], 16)
            local = pdist.shard_host_batch(batch_z, mesh)
            rows.append(sd.step_body(state, local, cfg, draws).tolist())
        return _flat(state.state_dict()), rows
    cfg = _tok_cfg(vq_backend="xla" if case.endswith("xla") else "pallas")
    state = tv.init_state(cfg, tv.make_tokenizer(cfg, "cpu"), mesh)
    for _ in range(2):
        batch = torch.from_numpy(rng.uniform(0, 1, (B, 16, 16, 1)).astype(np.float32))
        metrics, ok, _ = tv.train_step(state, pdist.shard_host_batch(batch, mesh), cfg)
        rows.append([metrics["loss"], metrics["grad_norm"], float(ok)])
    return _flat(state.state_dict()), rows


def _rollout_cfg(root, **kw):
    base = dict(checkpoint=os.path.join(root, "dp", "step_0000002"), platform="cpu",
                batch_size=2, num_frames=2, num_eval_iterations=2,
                output_dir=os.path.join(root, "ro"), name="ro")
    base.update(kw)
    return ro.RolloutConfig(**base)


def _scenarios(rank, root, tok_path, tok3_path):
    """Every world-2 run, in one order on both ranks; rank 0 keeps the
    results."""
    mesh = make_mesh()
    out = {"world": mesh.world}
    for case in STEP_CASES:
        out[case] = _run_steps(case, tok_path, mesh)
    # the sparse trainer with experts, evaluating after each step on rank 0
    # alone while rank 1 goes on to the next step's collectives
    res = sd.train(_sparse_cfg(
        decoder_model=tok3_path, output_dir=os.path.join(root, "moe"), name="moe",
        image_size=16, moe_experts=2, max_steps=2, eval_interval=1, eval_batch_size=2,
        num_eval_iterations=2, log_interval=1, buffer_size=60))
    flat = res.state.optimizer.flat
    every = pdist.all_gather_rows(flat[None], mesh)
    out["moe_train"] = dict(evals=[(s, tag) for s, tag, _, _ in res.evals],
                            ranks_equal=all(torch.equal(r, flat) for r in every),
                            ok=[bool(h[3]) for h in res.history])
    # the trainer under DP and FSDP, then each resumed from the other's
    # checkpoint: rank 0 alone writes
    base = _video_cfg(tok_path, max_steps=2, checkpoint_interval=1, name="r")
    for name, fsdp in (("dp", False), ("fsdp", True)):
        vd.train(dataclasses.replace(base, fsdp=fsdp, output_dir=os.path.join(root, name)))
    for name, fsdp, src in (("fsdp_from_dp", True, "dp"), ("dp_from_fsdp", False, "fsdp")):
        vd.train(dataclasses.replace(
            base, fsdp=fsdp, max_steps=3, output_dir=os.path.join(root, name),
            checkpoint=os.path.join(root, src, "step_0000002")))
    try:
        vd.train(dataclasses.replace(base, batch_size=3, output_dir=os.path.join(root, "x")))
    except ValueError as e:
        out["odd_batch"] = str(e)
    out["rollout"] = ro.run(_rollout_cfg(root, shard_batch=True)).decoded
    try:
        ro.run(_rollout_cfg(root, shard_batch=True, batch_size=3))
    except ValueError as e:
        out["odd_rollout"] = str(e)
    return out


def _worker(rank, port, root, tok_path, tok3_path):
    torch.set_num_threads(1)
    try:
        assert pdist.initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
        out = _scenarios(rank, root, tok_path, tok3_path)
    except BaseException:
        out = {"error": traceback.format_exc()}
    if rank == 0:
        torch.save(out, os.path.join(root, "world2.pt"))
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-2 results (spawned once for the module) and the tokenizer
    checkpoint they used."""
    root = str(tmp_path_factory.mktemp("dp"))
    paths = []
    for name, tok_cfg in (("tok", TOK_CFG), ("tok3", TOK3_CFG)):
        torch.manual_seed(0)
        tok = VQAutoEncoder(**tok_cfg, device="cpu")
        paths.append(save_checkpoint(os.path.join(root, name), 0,
                                     {"tokenizer": tok.state_dict()}, dict(tok_cfg)))
    tok_path = paths[0]
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, root, *paths)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not hung, f"processes {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = torch.load(os.path.join(root, "world2.pt"), weights_only=False)
    assert "error" not in out, out.get("error")
    return root, tok_path, out


def _close(got, want, tol=TOL, err=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=err)


def _one_process(fn):
    """``fn()`` on one thread, as the spawned ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _bn_cancelled(name):
    """The tokenizer decoder's conv1 bias feeds bn2, which subtracts it
    again: its exact gradient is 0, and f32 leaves noise (summed in another
    order over two ranks) that AdamW turns into steps of up to lr either
    way; bn2's running mean carries that bias (the rule of
    tests/test_torch_port_tokenizer_train.py)."""
    return name.startswith("tokenizer.decoder.") and name.endswith(
        ("conv1.bias", "bn2.running_mean"))


def _in_group_of_one(fn):
    """``fn(mesh)`` in a gloo group of one process: the tokenizer's
    BatchNorm then takes its two-pass moments, as on a larger data axis
    (one process without a group keeps torch's fused batch norm, which
    rounds otherwise)."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        return fn(make_mesh())
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("case", STEP_CASES)
def test_world2_step_equals_world1_step(runs, case):
    root, tok_path, out = runs
    assert out["world"] == WORLD
    got, got_rows = out[case]
    # the reference: one process, no group, the whole batch (the replicated
    # step for --fsdp: the two must agree)
    ref = case[: -len("_fsdp")] if case.endswith("_fsdp") else case
    run = (_in_group_of_one if case.startswith("tokenizer") else lambda f: f(Mesh()))
    want, want_rows = _one_process(lambda: run(lambda mesh: _run_steps(ref, tok_path, mesh)))
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith(("sampler.counts", "activation_count", ".count",
                          "num_batches_tracked")):
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        elif _bn_cancelled(name):
            # AdamW's steps on f32 noise: up to lr either way a step
            np.testing.assert_allclose(got[name], w, rtol=0, atol=2 * 2 * _tok_cfg().lr,
                                       err_msg=name)
        else:
            _close(got[name], w, err=name)
    _close(got_rows, want_rows)
    assert [r[2] for r in got_rows] == [1.0, 1.0]


def test_sparse_moe_trainer_evaluates_on_rank0_alone(runs):
    _, _, out = runs
    got = out["moe_train"]
    assert got["evals"] == [(1, "base"), (1, "ema"), (2, "base"), (2, "ema")]
    assert got["ranks_equal"] and got["ok"] == [True, True]


def _checkpoint(root, name, step):
    state, at, _ = restore_checkpoint(os.path.join(root, name, f"step_{step:07d}"))
    assert at == step
    return _flat(state)


def test_fsdp_trainer_equals_dp_and_checkpoints_resume_either_way(runs):
    root, _, _ = runs
    dp, fsdp = _checkpoint(root, "dp", 2), _checkpoint(root, "fsdp", 2)
    assert set(dp) == set(fsdp) and any(k.startswith("opt_state.mu") for k in dp)
    for name in dp:
        _close(fsdp[name], dp[name])
    a, b = _checkpoint(root, "fsdp_from_dp", 3), _checkpoint(root, "dp_from_fsdp", 3)
    for name in a:
        _close(a[name], b[name])
    assert int(a["opt_state.count"]) == 3


def test_rank0_alone_writes(runs):
    root, _, _ = runs
    for name in ("dp", "fsdp"):
        with open(os.path.join(root, name, "r_metrics.jsonl")) as f:
            steps = [json.loads(line)["step"] for line in f if '"loss"' in line]
        assert steps == [1, 2]  # each step logged once, by rank 0
        assert sorted(d for d in os.listdir(os.path.join(root, name))
                      if d.startswith("step_")) == ["step_0000001", "step_0000002"]


def test_shard_batch_rollout_gives_the_unsharded_pixels(runs):
    root, _, out = runs
    want = _one_process(lambda: ro.run(dataclasses.replace(
        _rollout_cfg(root), output_dir=os.path.join(root, "ro1"))).decoded)
    assert out["rollout"].shape == want.shape == (2, 2, 16, 16, 1)
    np.testing.assert_array_equal(out["rollout"], want)
    assert "must be divisible by 2 devices" in out["odd_rollout"]


def test_batches_the_data_axis_does_not_divide_raise(runs):
    _, _, out = runs
    assert "batch_size 3 must be divisible by the data-parallel axis (2 devices)" in out[
        "odd_batch"]
    with pytest.raises(ValueError, match="divisible"):
        check_batch(3, Mesh(0, 2))
    assert check_batch(4, Mesh(1, 2)) == 2 and Mesh(1, 2).rows(4) == (2, 4)


def test_mesh_of_one_process_and_unported_axes():
    mesh = make_mesh()
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    assert not pdist.initialize_distributed(num_processes=1, device="cpu")
    # the model axes are ported: one process cannot hold an axis of two
    for kw in (dict(n_model=2), dict(n_seq=2), dict(n_pipe=2)):
        with pytest.raises(ValueError, match="do not divide the world of 1 processes"):
            make_mesh(**kw)
    with pytest.raises(ValueError, match="n_data"):
        make_mesh(n_data=2)
    x = torch.arange(6.0)
    # no group: every collective is the identity
    for fn in (pdist.all_reduce_mean, pdist.all_reduce_sum, pdist.all_gather_rows,
               pdist.reduce_scatter_mean, pdist.mean_across, pdist.global_value):
        assert fn(x, mesh) is x
    assert pdist.rank_seed(7, 0) == 7 and pdist.rank_seed(7, 1) != 7
    assert pdist.process_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw", [dict(n_model=2), dict(n_seq=2)])
def test_video_trainer_axes_still_raise(tmp_path, kw):
    # ported: on one process the axis does not fit the world (n_model), or
    # the clip of n_past + 1 = 3 frames does not split in two (n_seq)
    with pytest.raises(ValueError, match="do not divide the world|must be divisible by n_seq"):
        vd.train(_video_cfg(str(tmp_path / "none"), output_dir=str(tmp_path), **kw))


@pytest.mark.parametrize("kw", [dict(n_pipe=2), dict(n_micro=2), dict(n_model=2)])
def test_sparse_trainer_axes_still_raise(tmp_path, kw):
    # ported: n_micro alone is unread (JAX reads it only under --n_pipe);
    # one process cannot hold an axis of two, nor one layer two stages
    if kw == dict(n_micro=2):
        sd.check_supported(_sparse_cfg(**kw))
        return
    with pytest.raises(ValueError, match="do not divide the world|not divisible by 2 stages"):
        sd.train(_sparse_cfg(decoder_model="x", output_dir=str(tmp_path), **kw))
