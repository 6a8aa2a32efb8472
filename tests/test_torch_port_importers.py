"""Port parity: the reference-checkpoint importers (``cli.import_torch_vqae``,
``cli.import_torch_video``) against the JAX package's on one reference
``.pth``, built here from seeded JAX weights through the JAX package's
``utils/torch_export.py`` (no reference checkpoint ships with the repo).

Both packages import the file; the port's tokenizer gives JAX's tokens
exactly and its denoiser JAX's logits within 1e-4 (f32 sums in another
order), and the port's rollout CLI runs on the imported checkpoints."""

import argparse
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from world_modelz_tpu.cli import import_torch_video as jitv  # noqa: E402
from world_modelz_tpu.cli import import_torch_vqae as jitq  # noqa: E402
from world_modelz_tpu.cli.train_vqae import load_tokenizer as jax_load_tokenizer  # noqa: E402
from world_modelz_tpu.cli.video_diffusion import VideoDiffusionConfig as JaxVdConfig  # noqa: E402
from world_modelz_tpu.cli.video_diffusion import make_model as jax_make_model  # noqa: E402
from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.models.video import VqVideoDiffusionModel as JaxDenoiser  # noqa: E402
from world_modelz_tpu.train.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from world_modelz_tpu.utils.config import config_from_dict as jax_config_from_dict  # noqa: E402
from world_modelz_tpu.utils.torch_export import (  # noqa: E402
    tokenizer_state_dict_from_state,
    video_state_dict_from_params,
)
from world_modelz_tpu_torch.cli import import_torch_video as pitv  # noqa: E402
from world_modelz_tpu_torch.cli import import_torch_vqae as pitq  # noqa: E402
from world_modelz_tpu_torch.cli import rollout as ro  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer  # noqa: E402
from world_modelz_tpu_torch.train import restore_checkpoint  # noqa: E402

TOK = dict(embedding_dim=8, num_embeddings=32, downscale_steps=2, hidden_planes=16,
           in_channels=1)
IMG, SHAPE = 32, (3, 8, 8)


def _pth(path, sd, ema=None, **opt):
    ckpt = {"step": 5, "model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                                            sd.items()},
            "opt": argparse.Namespace(**opt)}
    if ema is not None:
        ckpt["ema_model_state_dict"] = {k: torch.from_numpy(np.array(v)) for k, v in
                                        ema.items()}
    torch.save(ckpt, path)
    return str(path)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    root = tmp_path_factory.mktemp("import")
    tok = JaxTokenizer(**TOK)
    # jitted: one compile each instead of one for every op
    state = jax.jit(tok.init)(jax.random.PRNGKey(2), jnp.zeros((1, IMG, IMG, 1)))
    # non-trivial running statistics
    _, _, state = jax.jit(lambda st, x: tok.forward(st, x, train=True))(
        state, jax.random.uniform(jax.random.PRNGKey(3), (4, IMG, IMG, 1)))
    tok_pth = _pth(root / "tok.pth", tokenizer_state_dict_from_state(state),
                   embedding_dim=8, num_embeddings=32, downscale_steps=2, hidden_planes=16,
                   name="reftok")
    model = JaxDenoiser(data_shape=SHAPE, dim=16, num_classes=32, extents=(1, 1, 1),
                        depth=2, dim_head=8, mlp_dim=24, heads=2, backend="xla")
    params = jax.jit(model.init)(jax.random.PRNGKey(6),
                                 jnp.zeros((1, *SHAPE), jnp.int32))["params"]
    ema = jax.tree_util.tree_map(lambda x: x * 0.5, params)
    vid_pth = _pth(root / "video.pth", video_state_dict_from_params(params),
                   video_state_dict_from_params(ema), heads=2, extents="1,1,1",
                   ema_decay=0.99, name="refvid")
    out = {}
    for pkg, itq, itv in (("jax", jitq, jitv), ("port", pitq, pitv)):
        tok_ckpt = itq.run(itq.ImportTorchVqaeConfig(
            torch_checkpoint=tok_pth, output_dir=str(root / pkg / "tok"), image_size=IMG))
        vid_ckpt = itv.run(itv.ImportTorchVideoConfig(
            torch_checkpoint=vid_pth, decoder_model=tok_ckpt,
            output_dir=str(root / pkg / "vid"), image_size=IMG))
        out[pkg] = (tok_ckpt, vid_ckpt)
    return out


def test_imported_tokenizer_tokens_equal_jax(imported):
    jtok, jstate, jcfg = jax_load_tokenizer(imported["jax"][0])
    tok, cfg = load_tokenizer(imported["port"][0], "cpu")
    for key in ("embedding_dim", "num_embeddings", "downscale_steps", "hidden_planes",
                "in_channels", "image_size", "name"):
        assert cfg[key] == jcfg[key], key
    x = np.random.default_rng(8).random((3, IMG, IMG, 1), np.float32)
    want = np.asarray(jax.jit(jtok.encode)(jstate, jnp.asarray(x)))
    with torch.no_grad():
        got = tok.encode(torch.from_numpy(x)).numpy()
        dec = tok.decode(torch.from_numpy(want.copy())).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(dec, np.asarray(jax.jit(jtok.decode)(jstate, jnp.asarray(want))),
                               rtol=0, atol=1e-4)
    state, step, _ = restore_checkpoint(imported["port"][0])
    assert step == 5 and set(state) == {"tokenizer", "vq_stats"}


def test_imported_denoiser_logits_equal_jax(imported):
    jstate, jstep, jcfg = jax_restore(imported["jax"][1])
    state, step, cfg = restore_checkpoint(imported["port"][1])
    assert step == jstep == 5
    for key in ("n_past", "dim", "extents", "depth", "mlp_dim", "dim_head", "heads",
                "ema_decay", "name"):
        assert cfg[key] == jcfg[key], key
    assert state["opt_state"] == {} and set(state["sampler"]) >= {"weights", "counts"}
    jmodel = jax_make_model(jax_config_from_dict(JaxVdConfig, jcfg), SHAPE, 32)
    pcfg = vd.VideoDiffusionConfig(**{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in cfg.items()})
    model = vd.make_model(pcfg, SHAPE, 32, "cpu").eval()
    z = np.random.default_rng(1).integers(0, 33, (2, *SHAPE)).astype(np.int32)
    for part in ("params", "ema"):
        model.load_state_dict(state[part], strict=True)
        with torch.no_grad():
            got = model(torch.from_numpy(z).long()).numpy()
        want = np.asarray(jax.jit(jmodel.apply)({"params": jstate[part]}, jnp.asarray(z)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=part)


def test_rollout_cli_runs_on_the_imported_checkpoints(imported, tmp_path):
    for use_ema in (False, True):
        res = ro.run(ro.RolloutConfig(
            platform="cpu", checkpoint=imported["port"][1], batch_size=2, num_frames=2,
            num_eval_iterations=2, use_ema=use_ema, output_dir=str(tmp_path / str(use_ema))))
        assert res.step == 5 and res.decoded.shape == (2, 2, IMG, IMG, 1)
        assert np.isfinite(res.decoded).all()
    assert os.path.isfile(tmp_path / "True" / "rollout.gif")


def test_single_latent_codebook_and_missing_file(tmp_path):
    from world_modelz_tpu_torch.models import VQAutoEncoder

    torch.manual_seed(4)
    sd = {k: v.numpy() for k, v in VQAutoEncoder(**TOK, device="cpu").state_dict().items()}
    sd["vq.embedding"] = sd["vq.embedding"][0]
    sd["vq.cluster_size"] = sd["vq.cluster_size"][0]
    sd["vq.activation_count"] = np.arange(32, dtype=np.float32)
    path = pitq.run(pitq.ImportTorchVqaeConfig(
        torch_checkpoint=_pth(tmp_path / "t.pth", sd, hidden_planes=16),
        output_dir=str(tmp_path / "o"), image_size=IMG))
    state, _, cfg = restore_checkpoint(path)
    assert tuple(state["tokenizer"]["vq.embedding"].shape) == (1, 32, 8)
    assert (cfg["embedding_dim"], cfg["num_embeddings"], cfg["downscale_steps"]) == (8, 32, 2)
    np.testing.assert_array_equal(state["vq_stats"]["activation_count"].numpy(),
                                  np.arange(32, dtype=np.float32)[None])
    assert not state["vq_stats"]["accumulated_error"].any()
    with pytest.raises(ValueError, match="torch_checkpoint"):
        pitq.run(pitq.ImportTorchVqaeConfig())


@pytest.mark.parametrize("module", [pitq, pitv], ids=["vqae", "video"])
def test_importers_refuse_platform(module, capsys):
    # the conversion runs on the CPU: a --platform it would not read is refused
    with pytest.raises(SystemExit):
        module.main(["--torch_checkpoint", "t.pth", "--platform", "gpu"])
    assert "unrecognized arguments: --platform" in capsys.readouterr().err
