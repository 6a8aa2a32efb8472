"""Port parity: the masked-denoise trainer (``cli.masked_denoise``) against
the JAX package's, and the port's CLI end to end on the CPU.

``patchify``/``unpatchify`` must be exact. The patch quantizer's fit starts
from JAX's initial ``VQState`` (``convert.vq_state_from_state``) and takes
the same three batches: codebook and cluster sizes within 1e-5 x max(1,
max |x|), counts exact (f32 sums in another order). One train step is fed
the draws JAX splits from its step key (``StepDraws``); the JAX side is
``cli/masked_denoise.py``'s ``train_step`` written out (it is a closure of
``train``): the loss, the grad norm and the parameters after AdamW within
1e-5 x max(1, max |x|).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.cli import masked_denoise as jmd  # noqa: E402
from world_modelz_tpu.diffusion.schedules import named_schedule as jax_schedule  # noqa: E402
from world_modelz_tpu.models.gmlp import GMLP as JaxGMLP  # noqa: E402
from world_modelz_tpu.ops import vq as jvq  # noqa: E402
from world_modelz_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.cli import masked_denoise as md  # noqa: E402
from world_modelz_tpu_torch.train.checkpoint import restore_checkpoint  # noqa: E402

TOL = 1e-5
SMALL = dict(batch_size=4, image_size=32, level=3, d_model=32, depth=1,
             codebook_size=16, vq_steps=5, max_steps=5, eval_interval=5,
             eval_batch_size=2, num_eval_iterations=2, checkpoint_interval=0,
             log_interval=5, name="md")


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("patch", [2, 4])
def test_patchify_roundtrip_matches_jax(patch):
    x = _images(2, 16)
    want = np.asarray(jmd.patchify(jnp.asarray(x), patch))
    got = md.patchify(torch.from_numpy(x), patch)
    np.testing.assert_array_equal(got.numpy(), want)
    back = md.unpatchify(got, patch, 16 // patch)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jmd.unpatchify(jnp.asarray(want), patch, 16 // patch)))


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_fit_patch_vq_matches_jax(route):
    cfg = md.MaskedDenoiseConfig(**dict(SMALL, vq_steps=3))
    jcfg = jmd.MaskedDenoiseConfig(**dict(SMALL, vq_steps=3))
    patch = 4
    batches = [_images(4, seed=s) for s in range(3)]

    def feed():
        it = iter(batches)
        return lambda n=None: next(it)

    jstate = jmd.fit_patch_vq(jcfg, feed(), patch, jax.random.PRNGKey(1))
    init = jvq.vq_init(jax.random.PRNGKey(1), num_latents=1, num_embeddings=16,
                       embedding_dim=3 * patch * patch)
    state = md.fit_patch_vq(cfg, feed(), patch, convert.vq_state_from_state(init), route)
    _close(state.codebook.numpy(), jstate.codebook)
    _close(state.cluster_size.numpy(), jstate.cluster_size)
    np.testing.assert_array_equal(state.activation_count.numpy(),
                                  np.asarray(jstate.activation_count))
    _close(state.accumulated_error.numpy(), jstate.accumulated_error)


def _jax_step(cfg, model, params, opt, opt_state, vq_state, images, key, patch):
    """JAX's ``train_step`` (cli/masked_denoise.py:195-243) as the trainer
    builds it, returning its draws too."""
    grid = cfg.image_size // patch
    seq_len, d_patch, num_tokens = grid * grid, 3 * patch * patch, cfg.codebook_size
    schedule = jax_schedule(cfg.schedule_name)
    b = images.shape[0]
    k_r, k_mask, k_resample, k_uni, k_r2 = jax.random.split(key, 5)
    draws = dict(r=jax.random.uniform(k_r, (b, 1)),
                 mask_uniform=jax.random.uniform(k_mask, (b, seq_len)),
                 resample_uniform=jax.random.uniform(k_resample, (b, seq_len)),
                 uniform_classes=jax.random.randint(k_uni, (b, seq_len), 0, num_tokens),
                 r2=jax.random.uniform(k_r2, (b, 1)))
    vecs = jmd.patchify(images, patch).reshape(-1, 1, d_patch)
    encoding = jvq.vq_encode(vq_state, vecs.reshape(-1, d_patch)[:, None, :]).reshape(b, seq_len)
    r = schedule(draws["r"])
    mask = draws["mask_uniform"] < r
    r_pert = draws["r2"] if cfg.independent_uniform else r
    resample = draws["resample_uniform"] < r_pert * cfg.p_max_uniform
    inp = jnp.where(mask, num_tokens, jnp.where(resample, draws["uniform_classes"], encoding))
    emb = jvq.vq_decode_masked(vq_state, inp[..., None], num_tokens).reshape(b, seq_len, d_patch)

    def loss_fn(p):
        logits = model.apply({"params": p}, inp, emb)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.reshape(-1, num_tokens), encoding.reshape(-1)).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    return (optax.apply_updates(params, updates), opt_state, loss,
            optax.global_norm(grads), draws)


@pytest.mark.parametrize("independent", [False, True])
def test_train_step_matches_jax_under_its_draws(independent):
    cfg = md.MaskedDenoiseConfig(**dict(SMALL, independent_uniform=independent,
                                        schedule_name="cos2", platform="cpu"))
    jcfg = jmd.MaskedDenoiseConfig(**dict(SMALL, independent_uniform=independent,
                                          schedule_name="cos2"))
    patch, seq_len, d_patch = 4, 64, 48
    vq_state = jvq.vq_init(jax.random.PRNGKey(2), num_latents=1, num_embeddings=16,
                           embedding_dim=d_patch)
    jmodel = JaxGMLP(num_tokens_in=17, num_tokens_out=16, dim=32, depth=1,
                     seq_len=seq_len, vq_embedding_dim=d_patch)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, seq_len), jnp.int32),
                         jnp.zeros((1, seq_len, d_patch)))["params"]
    opt = jax_make_optimizer("adamw", optax.exponential_decay(cfg.lr, 25000, 0.5,
                                                              staircase=True),
                             cfg.weight_decay)
    images = _images(4, seed=5)
    step = jax.jit(lambda p, s, x, k: _jax_step(jcfg, jmodel, p, opt, s, vq_state, x, k,
                                                patch))
    new_params, _, jloss, jgn, jdraws = step(params, opt.init(params), jnp.asarray(images),
                                            jax.random.PRNGKey(4))

    task = md.make_task(cfg, convert.vq_state_from_state(vq_state), md.vq_route(d_patch))
    model = md.make_model(cfg, task, "cpu").train()
    model.load_state_dict(convert.gmlp_state_dict_from_params(jax.device_get(params)))
    popt = md.make_denoise_optimizer(cfg, model)
    draws = md.StepDraws(**{k: torch.from_numpy(np.array(v)) for k, v in jdraws.items()})
    draws.uniform_classes = draws.uniform_classes.long()
    loss, gn, ok = md.step_body(model, popt, task, torch.from_numpy(images), draws, cfg).tolist()
    assert ok == 1.0
    _close(loss, jloss)
    _close(gn, jgn)
    want = convert.gmlp_state_dict_from_params(jax.device_get(new_params))
    for name, p in model.state_dict().items():
        _close(p.numpy(), want[name].numpy())


def test_cli_writes_its_trace_and_a_checkpoint_that_restores(tmp_path):
    out = str(tmp_path)
    res = md.train(md.MaskedDenoiseConfig(**dict(SMALL, platform="cpu", output_dir=out,
                                                checkpoint_interval=5)))
    assert any(f.endswith("_eval_0000005.png") for f in os.listdir(out))
    assert len(res.losses) == 5 and np.isfinite(res.losses).all()
    assert res.program.captured is None  # eager on the CPU
    saved, at_step, config = restore_checkpoint(os.path.join(out, "step_0000005"))
    assert at_step == 5 and config["d_model"] == 32
    assert set(saved) == {"params", "vq", "opt_state"}
    torch.testing.assert_close(saved["vq"]["codebook"], res.vq.codebook, rtol=0, atol=0)
    # the guard's escalation puts the checkpoint back in place
    with torch.no_grad():
        for p in res.model.parameters():
            p.add_(1.0)
        res.optimizer.count_t.fill_(99)
    assert res.restore_latest() == os.path.join(out, "step_0000005")
    for name, p in res.model.state_dict().items():
        torch.testing.assert_close(p, saved["params"][name], rtol=0, atol=0)
    assert res.optimizer.count == 5
    # and training goes on from it
    md.step_body(res.model, res.optimizer, res.task, torch.zeros(4, 32, 32, 3),
                 md.draw_step(torch.Generator().manual_seed(0), 4, 64, 16),
                 dataclasses.replace(md.MaskedDenoiseConfig(**SMALL)))
    assert res.optimizer.count == 6


def test_cli_main_on_the_cpu_and_the_gpu_default(tmp_path, capsys):
    argv = ["--platform", "cpu", "--output_dir", str(tmp_path)] + [
        f"--{k}={v}" for k, v in dict(SMALL, max_steps=2, vq_steps=2, eval_interval=0,
                                      level=2).items()]
    md.main(argv)
    printed = capsys.readouterr().out
    assert "patch VQ: plain distance product (D=192 > 64)" in printed
    assert "loss plot" not in printed or "skipped" in printed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            md.main([a for a in argv if a not in ("--platform", "cpu")])
