"""The port's pipe axis (``parallel.pipeline``: the GPipe schedule over
``ppermute``, ``microbatch``; ``parallel.pipelined_sparse``: the sparse
denoiser's pipelined forward; the sparse trainer under ``--n_pipe``)
against the JAX package and against one process.

The port side runs in one spawned world of four gloo processes (joined
with a timeout of 120 s) that imports no JAX; the JAX side runs jitted in
this process on the 8 host devices of conftest.py. ``pipeline_apply``
over four stages (tests/test_pipeline.py's residual MLP block, eight
microbatches) and ``sparse_forward_pipelined`` at pipe=2 x data=2 (each
data rank its rows) are held to JAX's: values within rtol 1e-5, atol 1e-6
and every gradient within rtol 1e-4, atol 1e-6, the tolerances of
tests/test_pipeline.py; the sparse gradients are those of the whole
parameters, which the port reads from its stage-held ones (summed over
the data axis and gathered over the pipe axis), so the embeddings, whose
feed only stage 0 consumes, and the logit head are held too. The sparse
train step at pipe=2 x data=2 with n_micro=2 (and 4, which the global
batch of 4 takes and the per-rank batch of 2 does not: zero rows fill the
microbatches) must equal
the port's world-1 step within the data axis tests' tolerance
(tests/test_torch_port_data_parallel.py), 1e-6 x max(1, max |x|),
sampler counts exact.
"""

import os
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_data_parallel import (  # noqa: E402
    _close,
    _flat,
    _free_port,
    _one_process,
    _sparse_cfg,
)
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.models import VqSparseDiffusionModel  # noqa: E402
from world_modelz_tpu_torch.parallel import distributed as pdist  # noqa: E402
from world_modelz_tpu_torch.parallel import pipeline as ppipe  # noqa: E402
from world_modelz_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_params  # noqa: E402
from world_modelz_tpu_torch.parallel.pipelined_sparse import (  # noqa: E402
    sparse_forward_pipelined,
)

WORLD, B, JOIN_S = 4, 4, 120
N_STAGES, D, HIDDEN, ROWS, N_MICRO = 4, 6, 12, 16, 8
SPARSE = dict(shape=(4, 4, 4), dim=16, num_classes=12, depth=2, dim_head=8, mlp_dim=32,
              heads=2)
STEPS = {"sparse_pipe": 2, "sparse_pipe_ragged": 4}


def _stage_arrays():
    rng = np.random.default_rng(0)
    stages = [dict(w1=rng.normal(size=(D, HIDDEN)) * 0.3, b1=rng.normal(size=(HIDDEN,)) * 0.1,
                   w2=rng.normal(size=(HIDDEN, D)) * 0.3) for _ in range(N_STAGES)]
    stages = [{k: v.astype(np.float32) for k, v in s.items()} for s in stages]
    x = rng.normal(size=(ROWS, D)).astype(np.float32)
    tgt = rng.normal(size=(ROWS, D)).astype(np.float32)
    return stages, x, tgt


def _block(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


def _sparse_inputs():
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 13, size=(B, 12)).astype(np.int32)
    indices = rng.integers(0, 64, size=(B, 12)).astype(np.int32)
    tgt = rng.normal(size=(B, 12, 12)).astype(np.float32)
    return tokens, indices, tgt


def _pipeline_rank(mesh):
    """This stage's output, and its parameters' and the input's gradients
    of the mean squared error."""
    stages, x, tgt = _stage_arrays()
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in stages[mesh.pipe].items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ppipe.unmicrobatch(ppipe.pipeline_apply(_block, p, ppipe.microbatch(xt, N_MICRO),
                                                mesh))
    torch.mean((y - torch.from_numpy(tgt)) ** 2).backward()
    return dict(y=y.detach().numpy(), x=xt.grad.numpy(),
                **{k: v.grad.numpy() for k, v in p.items()})


def _sparse_rank(mesh, state_dict):
    """The pipelined forward on this data rank's rows: its logits and the
    whole parameters' gradients of sum((logits - tgt)^2) / numel."""
    tokens, indices, tgt = _sparse_inputs()
    model = VqSparseDiffusionModel(device="cpu", **SPARSE)
    model.load_state_dict(state_dict, strict=True)
    plan = shard_params(model, mesh)
    lo, hi = mesh.rows(B)
    y = sparse_forward_pipelined(model, torch.from_numpy(tokens[lo:hi]),
                                 torch.from_numpy(indices[lo:hi]), mesh, n_micro=2)
    (((y - torch.from_numpy(tgt[lo:hi])) ** 2).sum() / tgt.size).backward()
    grads = {n: pdist.all_reduce_sum(p.grad, mesh) for n, p in model.named_parameters()}
    return dict(y=pdist.all_gather_rows(y.detach(), mesh).numpy(),
                grads={k: v.numpy() for k, v in plan.gather_named(grads).items()})


def _run_steps(n_micro, mesh):
    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(2)
    cfg = _sparse_cfg(depth=2, n_pipe=mesh.n_pipe, n_micro=n_micro)
    state = sd.init_state(cfg, sd.make_model(cfg, 16, "cpu"), mesh)
    rows = []
    for _ in range(2):
        batch_z = torch.from_numpy(rng.integers(0, 16, (B, 4, 4, 4)))
        draws = sd.draw_step(gen, B, 24, 64, state.sampler.weights.shape[0], 16)
        local = pdist.shard_host_batch(batch_z, mesh)
        rows.append(sd.step_body(state, local, cfg, draws).tolist())
    return _flat(state.state_dict()), rows


def _scenarios(rank, root):
    out = {"pipeline": _pipeline_rank(make_mesh(n_pipe=4))}
    mesh = make_mesh(n_pipe=2)
    out["sparse"] = _sparse_rank(mesh, torch.load(os.path.join(root, "sparse.pt")))
    for case, n_micro in STEPS.items():
        out[case] = _run_steps(n_micro, mesh)
    return out


def _worker(rank, port, root):
    torch.set_num_threads(1)
    try:
        assert pdist.initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
        out = _scenarios(rank, root)
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(root, f"world_{rank}.pt"))
    torch.distributed.destroy_process_group()


def _jax_sparse():
    import jax
    import jax.numpy as jnp

    from world_modelz_tpu.models.video import VqSparseDiffusionModel as JaxSparse

    model = JaxSparse(**SPARSE)
    tokens, indices, _ = _sparse_inputs()
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(indices))
    return model, jax.device_get(params["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from world_modelz_tpu_torch import convert

    root = str(tmp_path_factory.mktemp("pipe"))
    _, params = _jax_sparse()
    torch.save(convert.sparse_state_dict_from_params(params), os.path.join(root, "sparse.pt"))
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, root)) for r in range(WORLD)]
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
    return outs


def test_pipeline_apply_matches_jax_values_and_gradients(runs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from world_modelz_tpu.parallel import pipeline as jpipe

    stages, x, tgt = _stage_arrays()
    mesh = JMesh(np.array(jax.devices()[:N_STAGES]), ("pipe",))

    def block(p, x):
        return x + jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]

    def run(stacked, x):
        return jpipe.unmicrobatch(jpipe.pipeline_apply(
            block, stacked, jpipe.microbatch(x, N_MICRO), mesh))

    def loss(stacked, x):
        return jnp.mean((run(stacked, x) - tgt) ** 2)

    stacked = jpipe.stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                        for s in stages])
    y = np.asarray(jax.jit(run)(stacked, jnp.asarray(x)))
    g_p, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(stacked, jnp.asarray(x))
    for stage, out in enumerate(runs):
        got = out["pipeline"]
        np.testing.assert_allclose(got["y"], y, rtol=1e-5, atol=1e-6)
        for k in ("w1", "b1", "w2"):
            np.testing.assert_allclose(got[k], np.asarray(g_p[k][stage]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        if stage == 0:  # the feed's gradient is stage 0's (it alone reads x)
            np.testing.assert_allclose(got["x"], np.asarray(g_x), rtol=1e-4, atol=1e-6)
    # the stacked layout of JAX's stages
    st = ppipe.stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()}
                                   for s in stages])
    assert tuple(st["w1"].shape) == (N_STAGES, D, HIDDEN)


def test_sparse_forward_pipelined_matches_jax(runs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from world_modelz_tpu.parallel.pipelined_sparse import (
        sparse_forward_pipelined as jax_pipelined,
    )
    from world_modelz_tpu_torch import convert

    model, params = _jax_sparse()
    tokens, indices, tgt = (jnp.asarray(a) for a in _sparse_inputs())
    mesh = JMesh(np.array(jax.devices()[:2]), ("pipe",))

    def run(p):
        return jax_pipelined(model, p, tokens, indices, mesh, n_micro=2)

    def loss(p):
        return jnp.sum((run(p) - tgt) ** 2) / tgt.size

    y = np.asarray(jax.jit(run)(params))
    grads = convert.sparse_state_dict_from_params(jax.device_get(jax.jit(jax.grad(loss))(params)))
    for out in runs:
        got = out["sparse"]
        np.testing.assert_allclose(got["y"], y, rtol=1e-5, atol=1e-6)
        assert set(got["grads"]) == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(got["grads"][k], g.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("case", list(STEPS))
def test_pipe_axis_step_equals_world1_step(runs, case):
    got, got_rows = runs[0][case]
    want, want_rows = _one_process(lambda: _run_steps(STEPS[case], Mesh()))
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith(("sampler.counts", ".count")):
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        else:
            _close(got[name], w, err=name)
    _close(got_rows, want_rows)
    assert [r[2] for r in got_rows] == [1.0, 1.0]
    for out in runs[1:]:
        for name, w in got.items():
            np.testing.assert_array_equal(out[case][0][name], w, err_msg=name)


def test_microbatch_round_trip_and_refusals(tmp_path):
    x = torch.arange(24.0).reshape(6, 4)
    assert torch.equal(ppipe.unmicrobatch(ppipe.microbatch(x, 3)), x)
    with pytest.raises(ValueError, match="batch 6 not divisible by n_micro 4"):
        ppipe.microbatch(x, 4)
    for kw, msg in ((dict(n_pipe=2, moe_experts=2), "cannot combine with --n_pipe"),
                    (dict(n_pipe=2, fsdp=True), "--fsdp cannot combine with --n_pipe"),
                    (dict(n_pipe=2, depth=3), "depth 3 not divisible by 2 stages"),
                    (dict(n_pipe=2, n_micro=3), "batch 4 not divisible by n_micro 3")):
        with pytest.raises(ValueError, match=msg):
            sd.check_supported(_sparse_cfg(**dict(dict(depth=2), **kw)))
    sd.check_supported(_sparse_cfg(n_micro=3))  # without --n_pipe, n_micro is unread
    model = VqSparseDiffusionModel(device="cpu", dropout=0.1, **SPARSE).train()
    z = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="deterministic; set dropout=0"):
        sparse_forward_pipelined(model, z, z, Mesh(n_pipe=2), n_micro=1)
