"""The port's model axis (``parallel.mesh``: the tensor-parallel rules,
``shard_params``, the plan's gathers; the split modules of
``models/attention.py``; expert sharding in ``parallel.moe``) against the
JAX package and against one process.

The rule table is held to JAX's ``rule_spec`` leaf for leaf, through
``convert.param_key_map`` (the weight bridge's own key mapping): the video
model, the sparse model (dense and with four experts) and the tokenizer,
at n_model 2 and at 3 (where the toy widths do not divide: JAX's fallback
to replication). The JAX side runs in this process on the 8 host devices
of conftest.py.

The port side runs in one spawned world of four gloo processes (joined
with a timeout of 120 s) that imports no JAX. Its train steps, each rank
given its rows of a global batch and the global batch's draws, must equal
the port's world-1 step on that batch (which the other port tests hold
to JAX) within the data axis tests' tolerance
(tests/test_torch_port_data_parallel.py), 1e-6 x max(1, max |x|), sampler counts
exact (the tokenizer's decoder biases that BatchNorm cancels within 2 lr a
step, as tests/test_torch_port_data_parallel.py holds them): the video
step at data=2 x model=2 (two heads split), with one head
(q, k and v gathered), with ``backend="fused"``'s plain version (both),
and under ``--fsdp``; the sparse step at data=2 x model=2 and with four
experts at model=4; the tokenizer at data=2 x model=2 (the model axis only
replicates it). Expert sharding equals the unsharded index form bit for
bit, values and gradients. Checkpoints are whole: one written under
model=2 loads at world 1 and one written at world 1 loads under model=2,
each state exactly the file's, each trainer resumes from the other's, and
``--eval`` under model=2 evaluates a whole checkpoint on rank 0.
"""

import dataclasses
import os
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_data_parallel import (  # noqa: E402
    TOK3_CFG,
    TOK_CFG,
    _bn_cancelled,
    _close,
    _flat,
    _free_port,
    _in_group_of_one,
    _one_process,
    _sparse_cfg,
    _tok_cfg,
    _video_cfg,
)
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.cli import train_vqae as tv  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer  # noqa: E402
from world_modelz_tpu_torch.models import VQAutoEncoder  # noqa: E402
from world_modelz_tpu_torch.parallel import distributed as pdist  # noqa: E402
from world_modelz_tpu_torch.parallel import moe as pmoe  # noqa: E402
from world_modelz_tpu_torch.parallel.mesh import (  # noqa: E402
    DEFAULT_TP_RULES,
    Mesh,
    make_mesh,
    rule_spec,
)
from world_modelz_tpu_torch.train import restore_checkpoint, save_checkpoint  # noqa: E402

WORLD, B, JOIN_S = 4, 4, 120
# case -> (mesh axes, config fields, attention backend)
VIDEO = {
    "video_tp": (dict(n_model=2), {}, "auto"),
    "video_tp_one_head": (dict(n_model=2), dict(heads=1), "auto"),
    "video_tp_fused": (dict(n_model=2), {}, "fused"),
    "video_tp_fused_one_head": (dict(n_model=2), dict(heads=1), "fused"),
    "video_tp_fsdp": (dict(n_model=2), dict(fsdp=True), "auto"),
}
SPARSE = {
    "sparse_tp": (dict(n_model=2), {}),
    "sparse_ep": (dict(n_model=4), dict(moe_experts=4, moe_capacity_factor=1.0)),
}
STEP_CASES = [*VIDEO, *SPARSE, "tokenizer_tp"]


def _run_steps(case, tok_path, mesh):
    """Two steps of ``case`` on the global batches of its seeds, this rank's
    rows of each; the state's whole tensors and the steps' rows."""
    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(2)
    rows = []
    if case in VIDEO:
        _, kw, backend = VIDEO[case]
        cfg = _video_cfg(tok_path, **kw)
        tok, _ = load_tokenizer(tok_path, "cpu")
        state = vd.init_state(cfg, vd.make_model(cfg, (3, 4, 4), 16, "cpu", backend), mesh)
        for _ in range(2):
            clips = torch.from_numpy(rng.integers(0, 256, (B, 3, 16, 16, 1), dtype=np.uint8))
            draws = vd.draw_step(gen, B, 16, state.sampler.weights.shape[0], 16)
            local = pdist.shard_host_batch(clips, mesh)
            rows.append(vd.step_body(state, tok, {"frames": local}, cfg, draws).tolist())
        return _flat(state.state_dict()), rows
    if case in SPARSE:
        cfg = _sparse_cfg(**SPARSE[case][1])
        state = sd.init_state(cfg, sd.make_model(cfg, 16, "cpu"), mesh)
        for _ in range(2):
            batch_z = torch.from_numpy(rng.integers(0, 16, (B, 4, 4, 4)))
            draws = sd.draw_step(gen, B, 24, 64, state.sampler.weights.shape[0], 16)
            local = pdist.shard_host_batch(batch_z, mesh)
            rows.append(sd.step_body(state, local, cfg, draws).tolist())
        return _flat(state.state_dict()), rows
    cfg = _tok_cfg(vq_backend="xla")
    state = tv.init_state(cfg, tv.make_tokenizer(cfg, "cpu"), mesh)
    for _ in range(2):
        batch = torch.from_numpy(rng.uniform(0, 1, (B, 16, 16, 1)).astype(np.float32))
        metrics, ok, _ = tv.train_step(state, pdist.shard_host_batch(batch, mesh), cfg)
        rows.append([metrics["loss"], metrics["grad_norm"], float(ok)])
    return _flat(state.state_dict()), rows


def _moe_inputs():
    g = torch.Generator().manual_seed(3)
    params = pmoe.moe_init(8, 12, 4, generator=g)
    x = torch.randn((2, 10, 8), generator=g)
    return params, x


def _moe_run(params, x, tp=None):
    """Values and gradients of the index form (``tp``: this rank's experts
    and, where they are its own, their gradients)."""
    leaves = [t.clone().requires_grad_(True) for t in params]
    xg = x.clone().requires_grad_(True)
    p = pmoe.MoEParams(*leaves)
    y, aux = pmoe.moe_ffn_indexed(p, xg, capacity=4, tp=tp)
    (torch.cos(y).sum() + aux).backward()
    return dict(y=y.detach(), aux=aux.detach(), x=xg.grad,
                **{n: t.grad for n, t in zip(pmoe.MoEParams._fields, leaves)})


def _checkpoints(mesh, root, tok_path, out):
    """The trainer under model=2 writes a whole checkpoint; world 1's
    checkpoint (written before the spawn) loads under model=2 and resumes."""
    base = _video_cfg(tok_path, max_steps=2, checkpoint_interval=2, name="c", n_model=2)
    vd.train(dataclasses.replace(base, output_dir=os.path.join(root, "tp")))
    w1 = os.path.join(root, "w1", "step_0000002")
    restored, at, _ = restore_checkpoint(w1)
    state = vd.init_state(base, vd.make_model(base, (3, 4, 4), 16, "cpu"), mesh)
    state.load_state_dict(restored, at)
    out["w1_loaded"] = _flat(state.state_dict())
    res = vd.train(dataclasses.replace(base, max_steps=3, checkpoint=w1,
                                       output_dir=os.path.join(root, "tp_from_w1")))
    out["tp_from_w1_ok"] = [bool(h[3]) for h in res.history]
    # --eval under model=2: rank 0 evaluates the whole checkpoint on a plain model
    vd.train(dataclasses.replace(base, eval=True, checkpoint=w1, eval_batch_size=2,
                                 eval_timesteps=1, num_eval_iterations=2,
                                 output_dir=os.path.join(root, "tp_eval")))


def _held(case, tok_path, mesh):
    """The parameter elements this rank holds of the case's model."""
    torch.manual_seed(0)
    if case in VIDEO:
        cfg = _video_cfg(tok_path, **VIDEO[case][1])
        model = vd.make_model(cfg, (3, 4, 4), 16, "cpu", VIDEO[case][2])
        vd.init_state(cfg, model, mesh)
    else:
        cfg = _sparse_cfg(**SPARSE[case][1])
        model = sd.make_model(cfg, 16, "cpu")
        sd.init_state(cfg, model, mesh)
    return sum(p.numel() for p in model.parameters())


def _scenarios(rank, root, tok_path, tok3_path):
    out = {}
    for case in STEP_CASES:
        axes = (VIDEO.get(case) or SPARSE.get(case) or (dict(n_model=2),))[0]
        out[case] = _run_steps(case, tok_path, make_mesh(**axes))
        if case != "tokenizer_tp":
            out[f"{case}_held"] = _held(case, tok_path, make_mesh(**axes))
    mesh = make_mesh(n_model=4)
    params, x = _moe_inputs()
    out["ep"] = _moe_run(pmoe.local_experts(params, mesh.model, 4), x, mesh.axis("model"))
    _checkpoints(make_mesh(n_model=2), root, tok_path, out)
    return out


def _worker(rank, port, root, tok_path, tok3_path):
    torch.set_num_threads(1)
    try:
        assert pdist.initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
        out = _scenarios(rank, root, tok_path, tok3_path)
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(root, f"world_{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results (one spawned world for the module), and the
    tokenizer checkpoint they used."""
    root = str(tmp_path_factory.mktemp("tp"))
    paths = []
    for name, tok_cfg in (("tok", TOK_CFG), ("tok3", TOK3_CFG)):
        torch.manual_seed(0)
        tok = VQAutoEncoder(**tok_cfg, device="cpu")
        paths.append(save_checkpoint(os.path.join(root, name), 0,
                                     {"tokenizer": tok.state_dict()}, dict(tok_cfg)))
    # world 1's checkpoint, for the world of four to load
    _one_process(lambda: vd.train(_video_cfg(
        paths[0], max_steps=2, checkpoint_interval=2, name="c",
        output_dir=os.path.join(root, "w1"))))
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
    outs = [torch.load(os.path.join(root, f"world_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    for out in outs:
        assert "error" not in out, out.get("error")
    assert [p.exitcode for p in procs] == [0] * WORLD
    return root, paths[0], outs


@pytest.mark.parametrize("case", STEP_CASES)
def test_model_axis_step_equals_world1_step(runs, case):
    _, tok_path, outs = runs
    got, got_rows = outs[0][case]
    run = _in_group_of_one if case.startswith("tokenizer") else (lambda f: f(Mesh()))
    want, want_rows = _one_process(lambda: run(lambda mesh: _run_steps(case, tok_path, mesh)))
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
    if not case.startswith("tokenizer"):  # the ranks hold shards, not the whole
        whole = sum(v.size for k, v in got.items() if k.startswith("params."))
        assert outs[0][f"{case}_held"] < whole
    # every rank holds the same whole state
    for out in outs[1:]:
        for name, w in got.items():
            np.testing.assert_array_equal(out[case][0][name], w, err_msg=name)


def test_expert_sharding_equals_the_unsharded_index_form_bitwise(runs):
    _, _, outs = runs
    params, x = _moe_inputs()
    want = _one_process(lambda: _moe_run(params, x))
    for rank, out in enumerate(outs):
        got = out["ep"]
        for name in ("y", "aux", "x", "w_gate"):
            assert torch.equal(got[name], want[name]), (rank, name)
        for name in ("w_in", "b_in", "w_out", "b_out"):  # rank r holds expert r
            assert torch.equal(got[name], want[name][rank:rank + 1]), (rank, name)


def test_checkpoints_are_whole_and_resume_across_layouts(runs):
    root, tok_path, outs = runs
    w1, _, _ = restore_checkpoint(os.path.join(root, "w1", "step_0000002"))
    loaded = outs[0]["w1_loaded"]
    assert set(loaded) == set(_flat(w1))
    for name, w in _flat(w1).items():
        np.testing.assert_array_equal(loaded[name], w, err_msg=name)
    assert outs[0]["tp_from_w1_ok"] == [True]
    assert os.path.exists(os.path.join(root, "tp_eval", "c_eval_0000002_base.png"))
    # model=2's checkpoint at world 1: the plain model takes it strictly
    path = os.path.join(root, "tp", "step_0000002")
    tp, at, _ = restore_checkpoint(path)
    cfg = _video_cfg(tok_path, max_steps=3, checkpoint=path,
                     output_dir=os.path.join(root, "w1_from_tp"))
    state = vd.init_state(cfg, vd.make_model(cfg, (3, 4, 4), 16, "cpu"))
    state.load_state_dict(tp, at)
    for name, w in _flat(tp).items():
        np.testing.assert_array_equal(_flat(state.state_dict())[name], w, err_msg=name)
    res = _one_process(lambda: vd.train(cfg))
    assert [bool(h[3]) for h in res.history] == [True]


def _jax_trees():
    import jax
    import jax.numpy as jnp

    from world_modelz_tpu.models.video import VqSparseDiffusionModel as JaxSparse
    from world_modelz_tpu.models.video import VqVideoDiffusionModel as JaxVideo

    video = JaxVideo(data_shape=(3, 4, 4), dim=32, num_classes=16, extents=(1, 1, 1),
                     depth=2, dim_head=16, mlp_dim=24, heads=2)
    z = jnp.zeros((1, 3, 4, 4), jnp.int32)
    trees = {"video": (convert.video_state_dict_from_params,
                       jax.eval_shape(video.init, jax.random.PRNGKey(0), z)["params"])}
    idx = jnp.zeros((1, 24), jnp.int32)
    for name, kw in (("sparse", {}), ("sparse_moe", dict(moe_experts=4))):
        m = JaxSparse(shape=(4, 4, 4), dim=32, num_classes=16, depth=2, dim_head=16,
                      mlp_dim=24, heads=2, attn_backend="xla", **kw)
        trees[name] = (convert.sparse_state_dict_from_params,
                       jax.eval_shape(m.init, jax.random.PRNGKey(0), idx, idx)["params"])
    return trees


@pytest.mark.parametrize("n_model", [2, 3])
def test_rule_table_matches_jax_leaf_for_leaf(n_model):
    import jax

    from world_modelz_tpu.parallel import mesh as jmesh

    jax_mesh = jmesh.make_mesh(n_model=n_model)
    counts = {}
    for name, (convert_fn, tree) in _jax_trees().items():
        shapes = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), tree)
        paths = {p: leaf for p, leaf in zip(
            jmesh._flatten_paths(shapes).values(), jax.tree_util.tree_leaves(shapes))}
        keys = convert.param_key_map(convert_fn, shapes)
        assert sorted(p for p, _ in keys.values()) == sorted(paths), name
        split = 0
        for key, (path, perm) in keys.items():
            want = tuple(jmesh.rule_spec(path, paths[path], jax_mesh, jmesh.DEFAULT_TP_RULES))
            want = want + (None,) * (paths[path].ndim - len(want))
            got = rule_spec(key, tuple(paths[path].shape[j] for j in perm), Mesh(n_model=n_model),
                            DEFAULT_TP_RULES)
            got = got + (None,) * (len(perm) - len(got))
            # the port's axis d is JAX's axis perm[d]
            assert tuple(want[j] for j in perm) == got, (name, key, path)
            split += "model" in got
        counts[name] = (split, len(keys))
    if n_model == 2:  # the toy shapes divide: JAX's rules match these leaves
        assert counts == {"video": (12, 34), "sparse": (8, 28), "sparse_moe": (12, 30)}
    else:  # 3 divides the FFN width 24 and the fused projection's 96 rows
        # alone (inner 32 and 4 experts fall back to replication)
        assert counts == {"video": (4, 34), "sparse": (6, 28), "sparse_moe": (2, 30)}
    # the tokenizer is conv: no rule matches, so the model axis replicates it
    tok = VQAutoEncoder(**TOK_CFG, device="cpu")
    for key, t in tok.state_dict().items():
        assert rule_spec(key, tuple(t.shape), Mesh(n_model=n_model), DEFAULT_TP_RULES) == ()


def test_refusals_match_jax():
    with pytest.raises(ValueError, match="combine pipe with data/model axes, not seq"):
        make_mesh(n_seq=2, n_pipe=2)
    with pytest.raises(ValueError, match="do not divide the world of 1 processes"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match="not the world"):
        make_mesh(n_data=2)
    with pytest.raises(ValueError, match="experts do not split"):
        pmoe.local_experts(_moe_inputs()[0], 0, 3)
