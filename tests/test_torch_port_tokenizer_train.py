"""Port parity: the tokenizer-training slice (``models`` training forward,
``cli.train_vqae``, ``train.schedules.step_decay_schedule``,
``data.trajectory``, ``utils.image``, ``utils.logging``) against the JAX
package, and the port's tokenizer trainer end to end on the CPU.

A small f32 tokenizer (D=8, K=16, 2 downscale steps, width 8, 16x16x1,
batch 4) with the same weights on both sides, carried across by
``world_modelz_tpu_torch.convert``. Tolerances: the training forward and
three whole train steps within 1e-5 (f32 convolutions and BatchNorm
reductions summed in another order, then AdamW); the schedule 1e-7
relative; synthetic frames and PNG pixels exact; the guard's rejection
bitwise.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu import train as jtrain  # noqa: E402
from world_modelz_tpu.data import SyntheticTrajectorySource as JaxSynthetic  # noqa: E402
from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.utils import image as jimage  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import train_vqae as tv  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.data import SyntheticTrajectorySource  # noqa: E402
from world_modelz_tpu_torch.models.conv import BatchNorm2d  # noqa: E402
from world_modelz_tpu_torch.utils import MetricLogger, make_grid, save_image  # noqa: E402

IMG, C, D, K, L, HID, B = 16, 1, 8, 16, 2, 8, 4
TOL = 1e-5
TOK_CFG = dict(embedding_dim=D, num_embeddings=K, downscale_steps=L,
               hidden_planes=HID, in_channels=C)


def _np(x):
    return np.array(jax.device_get(x))


def _bn_paths(tree):
    if hasattr(tree, "keys"):
        if "mean" in tree and "var" in tree:
            yield tree
        else:
            for v in tree.values():
                yield from _bn_paths(v)


def _jax_state(seed=0, vq_backend="xla"):
    """A JAX tokenizer and a state with perturbed weights, non-trivial BN
    statistics and VQ statistics."""
    rng = np.random.default_rng(seed)
    jtok = JaxTokenizer(**TOK_CFG, vq_backend=vq_backend)
    state = jtok.init(jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, C)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        state.params)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32),
        jax.device_get(state.batch_stats))
    for path in _bn_paths(stats):
        path["mean"] = (0.1 * rng.normal(size=path["mean"].shape)).astype(np.float32)
    vq = state.vq.replace(
        activation_count=jnp.asarray(rng.integers(0, 4, size=(1, K)).astype(np.float32)),
        accumulated_error=jnp.asarray(rng.uniform(size=(1, K)).astype(np.float32)))
    return jtok, state.replace(params=params, batch_stats=stats, vq=vq)


def _port_from(state, vq_backend="xla"):
    tok = tv.make_tokenizer(
        tv.TrainVqaeConfig(**TOK_CFG, vq_backend=vq_backend), "cpu")
    tok.load_state_dict(convert.tokenizer_state_dict_from_state(
        state.params, state.batch_stats, np.asarray(state.vq.codebook),
        np.asarray(state.vq.cluster_size)), strict=True)
    tok.vq.load_stats(convert.tokenizer_vq_stats(
        np.asarray(state.vq.codebook), np.asarray(state.vq.activation_count),
        np.asarray(state.vq.accumulated_error)))
    return tok


def _images(seed, n=B):
    return np.random.default_rng(seed).uniform(size=(n, IMG, IMG, C)).astype(np.float32)


def _bn_cancelled(key):
    """The decoder's conv1 bias feeds bn2, which subtracts it again: its
    exact gradient is 0, and f32 leaves noise that AdamW turns into steps
    of up to lr either way; bn2's running mean carries that bias."""
    return key.startswith("decoder.") and key.endswith(
        ("conv1.bias", "bn2.running_mean"))


def _assert_tokenizer_close(jstate, tok, tol=TOL, noise_tol=None):
    """Params, BN running statistics, codebook, cluster sizes and the VQ
    statistics of the port against a JAX state (BN-cancelled biases
    within ``noise_tol`` when given)."""
    want = convert.tokenizer_state_dict_from_state(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
        _np(jstate.vq.codebook), _np(jstate.vq.cluster_size))
    got = tok.state_dict()
    for key, val in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        t = noise_tol if noise_tol is not None and _bn_cancelled(key) else tol
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=tol,
                                   atol=t, err_msg=key)
    for name in ("activation_count", "accumulated_error"):
        np.testing.assert_allclose(getattr(tok.vq, name).numpy(),
                                   _np(getattr(jstate.vq, name)), rtol=tol,
                                   atol=tol, err_msg=name)


# ---------------------------------------------------- training forward


def test_batchnorm_running_update_is_flax_s():
    """Running statistics take the biased variance (flax), not torch's
    unbiased one: at n = 2 values per channel the two differ by 2x."""
    x = torch.tensor([[[[1.0]], [[4.0]]], [[[3.0]], [[-2.0]]]])  # (2, 2, 1, 1)
    bn = BatchNorm2d(2).train()
    y = bn(x)
    mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(
        y, (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5))
    assert int(bn.num_batches_tracked) == 0
    bn.eval()
    torch.testing.assert_close(bn(x), torch.nn.functional.batch_norm(
        x, bn.running_mean, bn.running_var, bn.weight, bn.bias, eps=1e-5))


@pytest.mark.parametrize("vq_backend", ["xla", "pallas"])
def test_training_forward_matches_jax(vq_backend):
    """recon, commitment loss, perplexity, BN running statistics and the
    new VQ state against JAX ``forward(train=True)``."""
    jtok, state = _jax_state(1, vq_backend)
    tok = _port_from(state, vq_backend)
    x = _images(2)
    jrecon, jout, jnew = jtok.forward(state, jnp.asarray(x), train=True)
    recon, out = tok(torch.from_numpy(x), train=True)
    assert not tok.encoder.training and not tok.decoder.training  # restored
    np.testing.assert_allclose(recon.detach().numpy(), _np(jrecon), atol=TOL)
    np.testing.assert_array_equal(out.indices.numpy(), _np(jout.indices))
    np.testing.assert_allclose(out.commitment_loss.item(),
                               float(jout.commitment_loss), rtol=TOL)
    np.testing.assert_allclose(out.perplexity.item(), float(jout.perplexity),
                               rtol=TOL)
    _assert_tokenizer_close(jnew, tok)


def test_eval_forward_keeps_bn_and_codebook():
    jtok, state = _jax_state(3)
    tok = _port_from(state)
    x = _images(4)
    jrecon, jout, jnew = jtok.forward(state, jnp.asarray(x), train=False)
    recon, out = tok(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(recon.detach().numpy(), _np(jrecon), atol=TOL)
    _assert_tokenizer_close(jnew, tok)  # statistics accumulate, EMA does not


# --------------------------------------------------------- train steps


def _cfg(**kw):
    base = dict(TOK_CFG, platform="cpu", batch_size=B, image_size=IMG,
                lr=1e-3, weight_decay=1e-2, lr_decay_interval=2,
                latent_loss_weight=0.5, dataset="moving_mnist")
    base.update(kw)
    return tv.TrainVqaeConfig(**base)


def _jax_step_fn(jtok, cfg):
    """The JAX trainer's step, composed from the package's public functions
    as cli/train_vqae.py:279-312 composes it (MAE)."""
    opt = jtrain.make_optimizer(cfg.optimizer, jtrain.step_decay_schedule(
        cfg.lr, steps_per_epoch=cfg.lr_decay_interval, epoch_step_size=1),
        cfg.weight_decay)

    @jax.jit
    def step(state, opt_state, batch):
        def loss(params):
            recon, out, new_state = jtok.forward(
                state.replace(params=params), batch, train=True)
            r_loss = jnp.mean(jnp.abs(recon - batch))
            return r_loss + cfg.latent_loss_weight * out.commitment_loss, new_state

        (total, new_state), grads = jax.value_and_grad(loss, has_aux=True)(
            state.params)
        gn = optax.global_norm(grads)
        updates, new_opt = opt.update(grads, opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return new_state.replace(params=params), new_opt, total, gn

    return opt, step


def test_three_f32_train_steps_match_the_jax_step():
    """Loss, grad norm, params, AdamW moments, BN statistics and the VQ
    state after each of three steps; the lr halves after step 2. The
    BN-cancelled biases (exact gradient 0) within 2 lr per step."""
    _three_steps_against_jax()


def test_three_f32_train_steps_in_a_process_group_match_the_jax_step():
    """The same three steps in a gloo process group of one, where the data
    axis's path runs: BatchNorm's global-batch moments in two passes
    (``models/conv.py:BatchNorm2d._global_forward``) and the VQ statistics
    all-reduced, held to JAX's (global-batch) step with the same
    tolerances."""
    import socket

    from world_modelz_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.group is not None
        _three_steps_against_jax(mesh)
    finally:
        torch.distributed.destroy_process_group()


def _three_steps_against_jax(mesh=None):
    cfg = _cfg()
    jtok, jstate = _jax_state(5)
    opt, jstep = _jax_step_fn(jtok, cfg)
    jopt = opt.init(jstate.params)
    pstate = tv.init_state(cfg, _port_from(jstate), mesh)
    names = dict(pstate.tok.named_parameters())
    for i in range(3):
        batch = _images(10 + i)
        jstate, jopt, jloss, jgn = jstep(jstate, jopt, jnp.asarray(batch))
        metrics, ok, _ = tv.train_step(pstate, torch.from_numpy(batch), cfg)
        assert ok and pstate.step == pstate.optimizer.count == i + 1
        assert abs(metrics["loss"] - float(jloss)) <= TOL
        assert abs(metrics["grad_norm"] - float(jgn)) <= TOL * max(1.0, float(jgn))
        _assert_tokenizer_close(jstate, pstate.tok,
                                noise_tol=2 * cfg.lr * (i + 1))
        adam = jopt[0]
        for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            want = convert.tokenizer_state_dict_from_state(
                jax.device_get(moment), jax.device_get(jstate.batch_stats),
                _np(jstate.vq.codebook))
            for name, p in names.items():
                mu, nu = pstate.optimizer.moments(p)
                np.testing.assert_allclose(
                    (mu if key == "exp_avg" else nu).numpy(),
                    want[name].numpy(), rtol=TOL, atol=TOL, err_msg=f"{key} {name}")
    assert pstate.optimizer.schedule(2) == cfg.lr / 2


def _snapshot(state):
    return copy.deepcopy({"sd": state.state_dict(), "step": state.step,
                          "count": state.optimizer.count})


def _assert_bitwise_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.is_floating_point():  # compare the bits (inf and nan too)
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            a, b = a.contiguous().view(bits), b.contiguous().view(bits)
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bitwise_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_a_nonfinite_step_leaves_the_state_unchanged():
    """A NaN batch: the forward's in-place BN and VQ updates are undone,
    the optimizer does not step; params, moments, BN statistics and the
    VQ state stay bitwise as they were."""
    cfg = _cfg()
    _, jstate = _jax_state(6)
    state = tv.init_state(cfg, _port_from(jstate))
    assert tv.train_step(state, torch.from_numpy(_images(7)), cfg)[1]
    before = _snapshot(state)
    nan = torch.full((B, IMG, IMG, C), float("nan"))
    metrics, ok, _ = tv.train_step(state, nan, cfg)
    assert not ok and not np.isfinite(metrics["loss"])
    after = _snapshot(state)
    after["step"] -= 1  # the loop's step counts the rejected step
    _assert_bitwise_equal(before, after)
    # without the guard the same batch poisons the parameters
    unguarded = _cfg(nan_guard=False)
    tv.train_step(state, nan, unguarded)
    assert not all(torch.isfinite(p).all() for p in state.tok.parameters())


# ----------------------------------------------- the trainer, end to end


def _tiny(out, **kw):
    base = dict(TOK_CFG, platform="cpu", batch_size=2, image_size=32,
                max_steps=4, log_interval=2, checkpoint_interval=2,
                vq_reuse_interval=2, output_dir=str(out), name="t",
                dataset="moving_mnist")
    base.update(kw)
    return tv.TrainVqaeConfig(**base)


def test_train_moving_mnist_logs_checkpoints_and_revives(tmp_path, capsys):
    result = tv.train(_tiny(tmp_path))
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines()
            if line.startswith("step ")] == ["step 1", "step 2", "step 4"]
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("step_")) == [
        "step_0000002", "step_0000004"]
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".png")) == [
        "t_reconst_0000002.png", "t_reconst_0000004.png"]
    with open(result.metrics_path) as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [1, 2, 4]
    assert all(np.isfinite(r["perplexity"]) and "lr" in r for r in logged)
    assert "reused" in logged[1] and "reused" in logged[2]  # revival at 2, 4
    assert result.rejected == 0 and result.state.step == 4
    assert result.checkpoint.endswith("step_0000004")
    # revival resets the statistics: what is left was gathered after it
    assert not result.state.tok.vq.activation_count.any()


def test_train_synthetic_rgb(tmp_path):
    result = tv.train(_tiny(tmp_path, dataset="synthetic", in_channels=3,
                            image_size=16, max_steps=2, vq_reuse_interval=0))
    assert result.state.tok.in_channels == 3 and len(result.history) == 2
    assert all(np.isfinite(h["loss"]) for h in result.history)


def test_resume_restores_the_whole_state_exactly(tmp_path):
    first = tv.train(_tiny(tmp_path / "a", max_steps=2, vq_reuse_interval=0))
    ckpt = first.checkpoint
    resumed = tv.train(_tiny(tmp_path / "b", max_steps=2, checkpoint=ckpt,
                             vq_reuse_interval=0))
    assert resumed.history == [] and resumed.state.step == 2
    _assert_bitwise_equal(_snapshot(first.state), _snapshot(resumed.state))
    more = tv.train(_tiny(tmp_path / "c", max_steps=3, checkpoint=ckpt,
                          vq_reuse_interval=0))
    assert [h["step"] for h in more.history] == [3]
    assert more.state.optimizer.count == 3


def test_load_tokenizer_reads_the_trainers_checkpoint(tmp_path):
    result = tv.train(_tiny(tmp_path, max_steps=2))
    tok, config = vd.load_tokenizer(result.checkpoint, "cpu")  # the denoiser's
    assert config["embedding_dim"] == D and config["dataset"] == "moving_mnist"
    _assert_bitwise_equal(tok.state_dict(), result.state.tok.state_dict())
    _assert_bitwise_equal(tok.vq.stats(), result.state.tok.vq.stats())
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 32, 32, C))
                         .astype(np.float32))
    tokens = tok.encode(x)
    assert tokens.shape == (2, 8, 8) and 0 <= int(tokens.min()) <= int(tokens.max()) < K


def test_a_converted_jax_tokenizer_becomes_a_training_state(tmp_path):
    """``convert.tokenizer_checkpoint_from_state`` carries the whole
    VQState; the trainer resumes from it with a fresh optimizer."""
    _, jstate = _jax_state(8)
    path = convert.tokenizer_checkpoint_from_state(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
        _np(jstate.vq.codebook), TOK_CFG, str(tmp_path / "jax"),
        cluster_size=_np(jstate.vq.cluster_size),
        activation_count=_np(jstate.vq.activation_count),
        accumulated_error=_np(jstate.vq.accumulated_error))
    tok, _ = tv.load_tokenizer(path, "cpu")
    _assert_tokenizer_close(jstate, tok, tol=0)
    cfg = _tiny(tmp_path / "run", image_size=16, max_steps=1, checkpoint=path,
                vq_reuse_interval=0)
    cfg.dataset, cfg.image_size = "moving_mnist", 32
    result = tv.train(cfg)
    assert result.state.step == 1 and result.state.optimizer.count == 1
    # omitted statistics are zeros
    zero = convert.tokenizer_vq_stats(np.zeros((1, K, D)))
    assert not any(t.any() for t in zero.values())


# --n_model is ported (tests/test_torch_port_tensor_parallel.py): on one
# process a model axis of two does not fit the world
UNPORTED = [dict(n_model=2)]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(tmp_path, kw):
    with pytest.raises(ValueError, match="do not divide the world of 1 processes"):
        tv.train(_tiny(tmp_path, **kw))


@pytest.mark.parametrize("kw", [dict(dataset="imagenet"), dict(vq_backend="cuda"),
                                dict(loss_fn="L3"), dict(data_pipeline="tf"),
                                dict(platform="tpu")],
                         ids=lambda kw: next(iter(kw)))
def test_invalid_options_raise(tmp_path, kw):
    with pytest.raises(ValueError):
        tv.train(_tiny(tmp_path, **kw))


def test_platform_default_needs_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tv.train(_tiny(tmp_path, platform=""))


@pytest.mark.parametrize("kind", ["MAE", "MSE", "SmoothL1"])
def test_recon_losses_match_jax(kind):
    from world_modelz_tpu.cli.train_vqae import _loss_fn as jax_loss

    rng = np.random.default_rng(9)
    a, b = (rng.normal(scale=2.0, size=(3, 5)).astype(np.float32) for _ in range(2))
    want = float(jax_loss(kind)(jnp.asarray(a), jnp.asarray(b)))
    got = tv._loss_fn(kind)(torch.from_numpy(a), torch.from_numpy(b)).item()
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


# ------------------------------------------------ schedule, data, images


@pytest.mark.parametrize("per_epoch,size", [(3, 1), (2, 3)])
def test_step_decay_schedule_matches_optax(per_epoch, size):
    want = jtrain.step_decay_schedule(2e-4, per_epoch, size)
    got = ptrain.step_decay_schedule(2e-4, per_epoch, size)
    read = ptrain.host_schedule(got)
    for step in range(0, 20):
        assert abs(read(step) - float(want(step))) <= 1e-7 * 2e-4, step


def test_synthetic_frames_equal_jax():
    kw = dict(num_trajectories=3, traj_frames=20, frame_size=24, seed=3)
    jsrc, psrc = JaxSynthetic(**kw), SyntheticTrajectorySource(**kw)
    assert list(psrc.trajectory_names()) == list(jsrc.trajectory_names())
    for name in psrc.trajectory_names():
        got = np.stack(list(psrc.load_frames(name)))
        want = np.stack(list(jsrc.load_frames(name)))
        assert got.dtype == np.uint8 and got.shape == (20, 24, 24, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3])
def test_save_image_png_pixels_equal_jax(tmp_path, channels):
    from PIL import Image

    rng = np.random.default_rng(channels)
    imgs = rng.uniform(-0.2, 1.2, size=(5, 6, 7, channels)).astype(np.float32)
    imgs[0, 0, 0] = np.nan
    np.testing.assert_array_equal(make_grid(imgs, nrow=3), jimage.make_grid(imgs, nrow=3))
    save_image(imgs, str(tmp_path / "port.png"))
    jimage.save_image(imgs, str(tmp_path / "jax.png"))
    with Image.open(tmp_path / "port.png") as got, Image.open(tmp_path / "jax.png") as want:
        assert got.mode == want.mode and got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_metric_logger_writes_jsonl(tmp_path):
    log = MetricLogger(str(tmp_path), "m")
    log.log(1, loss=torch.tensor(0.5), n=np.int64(3))
    log.log(2, loss=0.25)
    log.close()
    with open(tmp_path / "m_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["step"], r["loss"]) for r in rows] == [(1, 0.5), (2, 0.25)]
    assert rows[0]["n"] == 3 and "t" in rows[0]
    # without the wandb package: a warning, and the JSONL alone
    log = MetricLogger(str(tmp_path), "w", use_wandb=True)
    log.log(1, loss=0.5)
    log.close()
    with open(tmp_path / "w_metrics.jsonl") as f:
        assert [json.loads(line)["loss"] for line in f] == [0.5]
