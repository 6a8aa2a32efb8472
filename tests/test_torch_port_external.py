"""Port parity: the external tokenizers (``models.external``,
``models._gumbelvq_minimal``) and ``cli.sparse_diffusion --tokenizer``
against the JAX package's, on seeded weights and a taming-style yaml this
test writes (omegaconf is not installed, so both read it with the minimal
loader).

The minimal GumbelVQ copies build the same modules in the same order, so
one torch seed gives both the same weights (equal state_dicts) and the same
outputs, bitwise. The adapters run one torch codec on the CPU: tokens
equal, frames bitwise. ``NativeTokenizer`` over a JAX tokenizer carried
across by ``convert``: tokens equal on >= 99% of the grid (near-ties of f32
distances summed in another order), frames of the same tokens within 1e-4
(f32 convolutions in another order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.models import _gumbelvq_minimal as jgumbel  # noqa: E402
from world_modelz_tpu.models import external as jext  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.models import _gumbelvq_minimal as pgumbel  # noqa: E402
from world_modelz_tpu_torch.models import external as pext  # noqa: E402

IMG = 16
YAML = """model:
  target: taming.models.vqgan.GumbelVQ
  params:
    kl_weight: 1.0e-08
    temperature_scheduler_config: {target: x, params: {warm_up_steps: 0}}
    n_embed: 32
    embed_dim: 8
    ddconfig:
      double_z: false
      z_channels: 8
      resolution: 16
      in_channels: 3
      out_ch: 3
      ch: 8
      ch_mult: [1, 2, 2]
      num_res_blocks: 1
      attn_resolutions: []
      dropout: 0.0
    lossconfig: {target: x}
"""
DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=8, ch_mult=[1, 2, 2])


def _images(seed, b=3):
    return np.random.default_rng(seed).uniform(size=(b, IMG, IMG, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def taming_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("taming")
    cfg = root / "gumbel.yaml"
    cfg.write_text(YAML)
    torch.manual_seed(0)
    model = pgumbel.build(DD, n_embed=32, embed_dim=8)
    sd_ = {k: v + 0.05 * torch.randn_like(v) if v.is_floating_point() else v
           for k, v in model.state_dict().items()}
    ckpt = root / "model.ckpt"
    torch.save({"state_dict": sd_}, ckpt)
    return str(cfg), str(ckpt)


def test_minimal_gumbelvq_copy_equals_jax_packages():
    torch.manual_seed(3)
    jm = jgumbel.build(DD, n_embed=32, embed_dim=8).eval()
    torch.manual_seed(3)
    pm = pgumbel.build(DD, n_embed=32, embed_dim=8, kl_weight=1.0).eval()
    js, ps = jm.state_dict(), pm.state_dict()
    assert list(js) == list(ps)
    for k in js:
        assert torch.equal(js[k], ps[k]), k
    x = torch.from_numpy(_images(1)).permute(0, 3, 1, 2) * 2 - 1
    with torch.no_grad():
        zj, _, (_, _, ij) = jm.encode(x)
        zp, _, (_, _, ip) = pm.encode(x)
        assert torch.equal(ij, ip) and torch.equal(zj, zp)
        assert torch.equal(jm.decode(zj), pm.decode(zp))
        e = jm.quantize.get_codebook_entry(ij, (3, 4, 4, 8))
        assert torch.equal(e, pm.quantize.get_codebook_entry(ip, (3, 4, 4, 8)))
    cfg = pgumbel.AttrDict({"a": {"b": 1}})
    assert cfg.a.b == 1
    with pytest.raises(AttributeError):
        cfg.missing


def test_taming_adapter_matches_jax_adapter(taming_files):
    cfg, ckpt = taming_files
    ja = jext.TamingGumbelVQAdapter(cfg, ckpt)
    pa = pext.TamingGumbelVQAdapter(cfg, ckpt, device="cpu")
    assert pa.vendored and ja.vendored
    assert (pa.num_embeddings, pa.in_channels) == (ja.num_embeddings, 3) == (32, 3)
    images = _images(2)
    want = ja.encode(images)
    got = pa.encode(images)
    assert got.shape == (3, 4, 4) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor works as well as an array
    assert torch.equal(pa.encode(torch.from_numpy(images)), got)
    frames = pa.decode(got)
    np.testing.assert_array_equal(frames.numpy(), ja.decode(want))
    assert frames.shape == (3, IMG, IMG, 3) and 0 <= float(frames.min()) <= float(frames.max()) <= 1
    # the checkpoint was loaded (strict=False keeps the entries that match)
    torch.manual_seed(99)
    fresh = pext.TamingGumbelVQAdapter(cfg, "", device="cpu")
    assert not torch.equal(fresh.decode(got), frames)


@pytest.fixture(scope="module")
def native_pair(tmp_path_factory):
    tcfg = dict(embedding_dim=8, num_embeddings=16, downscale_steps=2, hidden_planes=8,
                in_channels=3)
    jtok = JaxTokenizer(**tcfg)
    state = jax.jit(jtok.init)(jax.random.PRNGKey(4), jnp.zeros((1, IMG, IMG, 3)))
    _, _, state = jax.jit(lambda st, x: jtok.forward(st, x, train=True))(
        state, jax.random.uniform(jax.random.PRNGKey(5), (4, IMG, IMG, 3)))
    state = jax.device_get(state)
    path = convert.tokenizer_checkpoint_from_state(
        state.params, state.batch_stats, state.vq.codebook, tcfg,
        str(tmp_path_factory.mktemp("ntok")))
    return jext.NativeTokenizer(jtok, state), path


def test_native_tokenizer_matches_jax(native_pair):
    jnat, path = native_pair
    pnat = pext.make_tokenizer(f"native:{path}", device="cpu")
    assert isinstance(pnat, pext.NativeTokenizer)
    assert isinstance(pnat, pext.FrameTokenizer)
    assert (pnat.num_embeddings, pnat.in_channels) == (16, 3)
    images = _images(6, b=4)
    want = np.asarray(jnat.encode(images))
    got = pnat.encode(images).numpy()
    assert got.shape == want.shape == (4, 4, 4)
    assert (got == want).mean() >= 0.99
    np.testing.assert_allclose(pnat.decode(want).numpy(), np.asarray(jnat.decode(want)),
                               rtol=0, atol=1e-4)


def test_make_tokenizer_specs(taming_files, native_pair):
    cfg, ckpt = taming_files
    tam = pext.make_tokenizer(f"taming:{cfg},{ckpt}", device="cpu")
    assert isinstance(tam, pext.TamingGumbelVQAdapter)
    assert isinstance(tam, pext.FrameTokenizer)
    with pytest.raises(ValueError, match="unknown tokenizer spec"):
        pext.make_tokenizer("vqgan:x", device="cpu")
    # the GPU is the default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pext.make_tokenizer(f"taming:{cfg},{ckpt}")


@pytest.mark.parametrize("kind", ["taming", "native"])
def test_sparse_cli_trains_with_an_external_tokenizer(taming_files, native_pair, tmp_path,
                                                      kind):
    """--tokenizer in place of --decoder_model: the batch encode and the
    evaluation's decode go through it."""
    if kind == "taming":
        spec = "taming:{},{}".format(*taming_files)
        classes = 32
    else:
        spec = f"native:{native_pair[1]}"
        classes = 16
    result = sd.train(sd.SparseDiffusionConfig(
        platform="cpu", tokenizer=spec, output_dir=str(tmp_path), image_size=IMG,
        S=4, H=4, W=4, num_context=32, batch_size=2, eval_batch_size=1, dim=16, mlp_dim=16,
        heads=2, depth=1, max_steps=2, warmup=1, eval_interval=2, num_eval_iterations=2,
        checkpoint_interval=2, buffer_size=60, log_interval=1, name="ext"))
    assert [h[0] for h in result.history] == [1, 2]
    assert all(np.isfinite(h[1]) for h in result.history)
    assert result.state.model.num_classes == classes
    assert [e[1] for e in result.evals] == ["base"]
    assert os.path.isfile(result.evals[0][2])
    tok = pext.make_tokenizer(spec, device="cpu")
    vol = torch.full((1, 4, 4, 4), classes)  # the mask token decodes as code 0
    frames = sd.decode_volume(tok, vol, decode_n=3)
    assert frames.shape == (1, 4, IMG, IMG, 3)
    np.testing.assert_array_equal(frames, sd.decode_volume(tok, torch.zeros_like(vol), decode_n=3))


def test_config_written_as_json_loads_without_pyyaml(tmp_path, monkeypatch):
    """A machine without PyYAML (the card's) reads a config written as
    JSON, which is yaml too: the same adapter either way."""
    import json
    import sys

    import yaml

    cfg = tmp_path / "gumbel.yaml"
    cfg.write_text(json.dumps(yaml.safe_load(YAML)))
    with_yaml = pgumbel.load_config(str(cfg))
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises
    without = pgumbel.load_config(str(cfg))
    # (PyYAML reads JSON's 1e-08 as a string, json as a float: the model's
    # fields agree)
    assert without.model.params.ddconfig == with_yaml.model.params.ddconfig
    assert without.model.params.n_embed == with_yaml.model.params.n_embed == 32
    adapter = pext.TamingGumbelVQAdapter(str(cfg), "", device="cpu")
    assert adapter.num_embeddings == 32 and adapter.in_channels == 3
