"""The port's SOM-DDPM pipeline (``cli.som_pipeline``): the five stages
chained through their checkpoints on the CPU at tiny sizes (as the JAX
package's tests/test_cli_smoke.py:388), ``--dataset files`` on images the
test writes, and the stage steps against the JAX package's steps on the
same weights and draws.

Tolerances: one autoencoder step (train_ae, and finetune_ae with its SOM
adaption) against JAX's step_fn composed from the package's functions and
run in float64 (JAX's f32 BatchNorm gradient is the less exact of the two
here, see the test):
loss 1e-5, gradients 1e-5 x max(1, max |g|), BatchNorm statistics and the
SOM 1e-5, parameters 1e-5 where |g| > 1e-6 (AdamW's first update is
lr * sign(g), and f32 convolutions summed in another order may flip the
sign of a gradient near 0) and within 2 lr elsewhere; three DDPM steps (AdamW after a
warmup, EMA) on JAX's draws and JAX's timestep embedding: loss 1e-5, grad
norm 1e-4 relative (flax's GroupNorm variance E[x^2] - E[x]^2 in f32; the
UNet's gradients themselves are held in test_torch_port_unet.py),
parameters and EMA 1e-5 where every step's gradient exceeds 1e-3 of the
largest (Adam divides by |g|, so a gradient near 0 may take either sign:
a conv bias before a GroupNorm of one channel a group has a gradient of
f32 noise) and everywhere within twice the summed learning rates."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu import train as jtrain  # noqa: E402
from world_modelz_tpu.diffusion import ddpm as jddpm  # noqa: E402
from world_modelz_tpu.models import unet as junet  # noqa: E402
from world_modelz_tpu.models.som_autoencoder import SomAutoEncoder as JaxSomAE  # noqa: E402
from world_modelz_tpu.ops import som as jsom  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.cli import som_pipeline as sp  # noqa: E402
from world_modelz_tpu_torch.models import unet as punet  # noqa: E402
from world_modelz_tpu_torch.models.som_autoencoder import SomAutoEncoder  # noqa: E402
from world_modelz_tpu_torch.utils.image import save_image  # noqa: E402

TOL = 1e-5
IMG = 32
AE = dict(downscale_steps=2, embedding_dim=8, hidden_planes=16)


def _chain(tmp_path, **data):
    r1 = sp.train_ae(sp.TrainAeConfig(
        platform="cpu", batch_size=8, image_size=IMG, max_steps=4, checkpoint_interval=2,
        log_interval=2, output_dir=str(tmp_path / "s1"), name="s1", **AE, **data))
    r2 = sp.train_som(sp.TrainSomConfig(
        platform="cpu", ae_checkpoint=r1.path, batch_size=8, image_size=IMG, som_width=8,
        som_height=8, sigma_begin=4.0, sigma_end=0.5, max_steps=3, checkpoint_interval=3,
        log_interval=1, adapt_batch_size=64, output_dir=str(tmp_path / "s2"), name="s2",
        **data))
    r3 = sp.finetune_ae(sp.FinetuneAeConfig(
        platform="cpu", som_checkpoint=r2.path, batch_size=8, image_size=IMG, max_steps=3,
        checkpoint_interval=0, log_interval=1, som_adapt_batch=32,
        output_dir=str(tmp_path / "s3"), name="s3", **data))
    return r1, r2, r3


def test_five_stages_chain_through_checkpoints(tmp_path):
    r1, r2, r3 = _chain(tmp_path)
    assert r1.path.endswith("step_0000004") and [h["step"] for h in r1.history] == [1, 2, 4]
    assert os.path.isfile(tmp_path / "s1" / "s1_reconst_0000002.png")
    assert all(h["ok"] and np.isfinite(h["loss"]) for h in r1.history)
    assert [h["step"] for h in r2.history] == [1, 2, 3]
    assert os.path.isfile(tmp_path / "s2" / "s2_som_0000003.png")
    assert r3.history[-1]["som_loss"] > 0  # the SOM adapted every step (skip 0)
    data = sp.create_diffusion_dataset(sp.CreateDatasetConfig(
        platform="cpu", checkpoint=r3.path, batch_size=8, image_size=IMG, max_examples=16,
        dataset_fn=str(tmp_path / "latents.npz")))
    assert data.shape == (16, 8, 8, 2) and np.abs(data).max() <= 1.0
    with open(str(tmp_path / "latents.npz") + ".json") as f:
        assert json.load(f)["som_width"] == 8
    # the rehydration contract
    ae, config = sp.load_som_ae(r3.path, device="cpu")
    assert (ae.som_width, ae.embedding_dim, config["downscale_steps"]) == (8, 8, 2)
    np.testing.assert_array_equal(ae.encode_2d(torch.from_numpy(np.zeros((1, IMG, IMG, 3),
                                                                          np.float32))).shape,
                                  (1, 8, 8, 2))
    r5 = sp.train_diffusion(sp.TrainDiffusionConfig(
        platform="cpu", input_dataset=str(tmp_path / "latents.npz"), decoder_model=r3.path,
        batch_size=4, model_channels=32, num_res_blocks=1, channel_mult=(1, 2), max_steps=4,
        warmup=2, eval_interval=4, eval_timesteps=5, eval_batch_size=2, eval_trace_steps=3,
        checkpoint_interval=4, log_interval=2, ema_decay=0.9, accumulation_steps=2,
        output_dir=str(tmp_path / "s5")))
    files = os.listdir(tmp_path / "s5")
    assert {"diffusion_sampling_0000004_base.png", "diffusion_sampling_0000004_ema.png",
            "step_0000004"} <= set(files)
    assert r5.model.training and [h["step"] for h in r5.history] == [1, 2, 4]
    state = sp.restore_checkpoint(r5.path)[0]
    assert set(state) == {"params", "ema", "opt_state"} and "acc" in state["opt_state"]


def test_stages_read_image_files_and_the_cli_dispatches(tmp_path):
    rng = np.random.default_rng(0)
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir / "sub")
    for i in range(6):
        save_image(rng.uniform(size=(IMG, IMG, 3)), str(img_dir / "sub" / f"f{i}.png"))
    (img_dir / "sub" / "broken.png").write_bytes(b"not a png")
    data = dict(dataset="files", file_list_fn=str(tmp_path / "files.json"),
                image_dir_path=str(img_dir / "**" / "*"))
    batch = sp.image_batch_fn("files", data["file_list_fn"], data["image_dir_path"],
                              r".*\.png$", 4, IMG, 0)()
    assert batch.shape == (4, IMG, IMG, 3) and batch.dtype == np.float32
    r1 = sp.main(["train_ae", "--platform", "cpu", "--batch_size", "4", "--image_size",
                  str(IMG), "--max_steps", "2", "--checkpoint_interval", "0",
                  "--downscale_steps", "2", "--embedding_dim", "8", "--hidden_planes", "16",
                  "--dataset", "files", "--file_list_fn", data["file_list_fn"],
                  "--image_dir_path", data["image_dir_path"],
                  "--output_dir", str(tmp_path / "s1")])
    assert r1.path.endswith("step_0000002")
    out = sp.create_diffusion_dataset(sp.CreateDatasetConfig(
        platform="cpu", checkpoint=r1.path, batch_size=4, image_size=IMG, max_examples=6,
        dataset_fn=str(tmp_path / "d" / "lat.npz"), **data))
    assert out.shape == (6, 8, 8, 2)
    with pytest.raises(SystemExit):
        sp.main(["bogus"])
    with pytest.raises(ValueError, match="dataset"):
        sp.image_batch_fn("imagenet", "", "", "", 1, IMG, 0)
    with pytest.raises(ValueError, match="ae_checkpoint"):
        sp.train_som(sp.TrainSomConfig(platform="cpu"))


@pytest.fixture(scope="module")
def jax_ae():
    jae = JaxSomAE(**AE, in_channels=3, som_width=4, som_height=4, pass_through_som=True)
    state = jax.jit(jae.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))
    _, _, _, state = jax.jit(lambda st, x: jae.forward(st, x, train=True))(
        state, jax.random.uniform(jax.random.PRNGKey(4), (4, 16, 16, 3)))
    return jae, jax.device_get(state)


@pytest.mark.parametrize("finetune", [False, True])
def test_ae_step_matches_the_jax_step(jax_ae, finetune):
    """One train_ae (SOM bypassed) or finetune_ae (through the SOM, its
    adaption interleaved) step: AdamW at lr 2e-4, SmoothL1."""
    jae, state = jax_ae
    x = np.random.default_rng(5).uniform(size=(4, 16, 16, 3)).astype(np.float32)
    jae = jae if finetune else JaxSomAE(**AE, in_channels=3, som_width=4, som_height=4)
    opt = jtrain.make_optimizer("AdamW", 2e-4)

    def loss(params, st, xx):
        recon, h_in, h_diff, new = jae.forward(st.replace(params=params), xx, train=True)
        total = jnp.mean(optax.huber_loss(recon, xx, delta=1.0))
        if finetune:
            total = total + 0.25 * h_diff
        return total, (new, h_in)

    # the JAX step in float64: flax's BatchNorm takes the variance as
    # E[x^2] - E[x]^2, whose f32 cancellation moved one bias gradient of
    # this state from -0.00202 (float64, both packages; and the port's f32)
    # to -0.00645 in JAX's f32
    with jax.enable_x64(True):
        st64 = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a,
            state)
        (want, (new, h_in)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            st64.params, st64, x.astype(np.float64))
        upd, _ = opt.update(grads, opt.init(st64.params), st64.params)
        params = optax.apply_updates(st64.params, upd)
        som = st64.som
        if finetune:
            som, _ = jsom.som_adapt(st64.som, jax.lax.stop_gradient(h_in), 0.02, 0.25,
                                    adapt_batch_size=8)
        params, grads, new, som, want = jax.device_get((params, grads, new, som, want))
    want_state = convert.som_tokenizer_state_from_state(params, new.batch_stats, som)

    ae = SomAutoEncoder(**AE, in_channels=3, pass_through_som=finetune, device="cpu")
    ae.load_tokenizer_state(convert.som_tokenizer_state_from_state(
        state.params, state.batch_stats, state.som))
    popt = sp.make_optimizer("AdamW", ae.parameters(), 2e-4)
    loss_v, _, _, ok = sp._ae_step(ae, popt, torch.from_numpy(x), sp._recon_loss("SmoothL1"),
                                   True, 0.25, (0.02, 0.25, 8) if finetune else None)
    assert bool(ok) and abs(float(loss_v) - float(want)) <= TOL
    gsd = convert.som_tokenizer_state_from_state(grads, new.batch_stats, state.som).state_dict
    for name, p in ae.named_parameters():
        g = gsd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(g).max())), err_msg=name)
        # Adam's first update is lr * g / (|g| + eps): its sign is the
        # gradient's, which f32 sums in another order may flip where |g|
        # is near 0, so those weights are held to the step's size only
        firm = np.abs(g) > 1e-6
        want_p = want_state.state_dict[name].numpy()
        np.testing.assert_allclose(p.detach().numpy()[firm], want_p[firm], rtol=0, atol=TOL,
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), want_p, rtol=0, atol=2 * 2e-4 + TOL,
                                   err_msg=name)
    for k, v in ae.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_state.state_dict[k].numpy(), rtol=0,
                                       atol=TOL, err_msg=k)
    np.testing.assert_allclose(ae.som.embedding.numpy(), want_state.som.embedding.numpy(),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(ae.som.activation_count.numpy(),
                                  want_state.som.activation_count.numpy())


def test_ae_step_rejects_a_nonfinite_batch(jax_ae):
    _, state = jax_ae
    ae = SomAutoEncoder(**AE, in_channels=3, pass_through_som=True, device="cpu")
    ae.load_tokenizer_state(convert.som_tokenizer_state_from_state(
        state.params, state.batch_stats, state.som))
    before = {k: v.clone() for k, v in ae.state_dict().items()}
    som = ae.som.embedding.clone()
    opt = sp.make_optimizer("AdamW", ae.parameters(), 2e-4)
    x = torch.rand(2, 16, 16, 3)
    x[0, 0, 0, 0] = float("nan")
    _, _, _, ok = sp._ae_step(ae, opt, x, sp._recon_loss("MSE"), True, 0.25, (0.02, 0.25, 8))
    assert not bool(ok) and opt.count == 0
    for k, v in ae.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(ae.som.embedding, som)


UNET = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2))


def test_three_ddpm_steps_match_the_jax_step(monkeypatch):
    cfg = sp.TrainDiffusionConfig(platform="cpu", lr=1e-3, warmup=2, max_steps=10,
                                  ema_decay=0.9, **UNET)
    jm = junet.UNetDiffusionModel(in_channels=2, out_channels=2, dropout=0.0, **UNET)
    b, shape = 3, (8, 8, 2)
    params = jax.jit(jm.init)(jax.random.PRNGKey(6), jnp.zeros((1, *shape)),
                              jnp.zeros((1, 1)))["params"]
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    sched = jtrain.warmup_cosine_schedule(cfg.lr, cfg.warmup, cfg.max_steps)
    opt = jtrain.make_optimizer("AdamW", sched, 0.0)

    @jax.jit
    def jstep(p, ema, opt_state, batch, t, eps):
        def loss(pp):
            a = jddpm.alpha_bar(t.reshape(-1, 1, 1, 1))
            xt = batch * jnp.sqrt(a) + eps * jnp.sqrt(1.0 - a)
            return jnp.mean((jm.apply({"params": pp}, xt, t) - eps) ** 2)

        val, grads = jax.value_and_grad(loss)(p)
        gn = optax.global_norm(grads)
        upd, opt_state = opt.update(grads, opt_state, p)
        p = optax.apply_updates(p, upd)
        return p, jtrain.ema_update(ema, p, cfg.ema_decay), opt_state, val, gn, grads

    def emb(t, d, stretch=5000.0, max_period=1e4):
        return torch.from_numpy(np.array(junet.timestep_embedding(
            jnp.asarray(t.detach().numpy()), d, stretch=stretch, max_period=max_period)))

    monkeypatch.setattr(punet, "timestep_embedding", emb)
    model = sp.make_unet(cfg, "cpu")
    model.load_state_dict(convert.unet_state_dict_from_params(params), strict=True)
    from world_modelz_tpu_torch.cli.video_diffusion import init_state

    state = init_state(cfg, model)
    jp, jema, jopt = params, jtrain.ema_init(params), opt.init(params)
    firm, moved = {}, 0.0
    for i in range(3):
        batch = rng.uniform(-1, 1, size=(b, *shape)).astype(np.float32)
        t = rng.uniform(size=(b, 1)).astype(np.float32)
        eps = rng.normal(size=(b, *shape)).astype(np.float32)
        jp, jema, jopt, val, gn, grads = jstep(jp, jema, jopt, batch, t, eps)
        loss, pgn, ok = sp.ddpm_step(state, torch.from_numpy(batch), torch.from_numpy(t),
                                     torch.from_numpy(eps), cfg, sp._recon_loss("MSE")).tolist()
        assert ok == 1.0
        assert abs(loss - float(val)) <= TOL * max(1.0, float(val))
        assert abs(pgn - float(gn)) <= 1e-4 * float(gn)
        moved += float(sched(i))
        want = convert.unet_state_dict_from_params(jax.device_get(jp))
        want_ema = convert.unet_state_dict_from_params(jax.device_get(jema))
        g = convert.unet_state_dict_from_params(jax.device_get(grads))
        top = max(float(v.abs().max()) for v in g.values())
        for name, p in model.named_parameters():
            firm[name] = firm.get(name, True) & (np.abs(g[name].numpy()) > 1e-3 * top)
            got, w = p.detach().numpy(), want[name].numpy()
            np.testing.assert_allclose(got[firm[name]], w[firm[name]], rtol=0, atol=TOL,
                                       err_msg=f"{i} {name}")
            np.testing.assert_allclose(got, w, rtol=0, atol=2 * moved + TOL,
                                       err_msg=f"{i} {name}")
            np.testing.assert_allclose(state.ema[name].numpy()[firm[name]],
                                       want_ema[name].numpy()[firm[name]], rtol=0, atol=TOL,
                                       err_msg=f"{i} ema {name}")
