"""Port parity: the sparse-diffusion importer (``cli.import_torch_sparse``)
against the JAX package's, on reference ``.pth`` files built here from
seeded JAX sparse params through ``convert.sparse_state_dict_from_params``
(the JAX package's ``torch_export.py`` has no sparse writer).

A dense model: both importers read one file; the port's weights are JAX's
imported params carried across (exactly), the configs agree, and the
port's logits equal JAX's within 1e-5 (f32 sums in another order). A
mixture-of-experts model (which the JAX importer does not read): the
port's imported model gives ``model.apply`` of the JAX params within
1e-5."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.cli import import_torch_sparse as jits  # noqa: E402
from world_modelz_tpu.models.video import VqSparseDiffusionModel as JaxSparse  # noqa: E402
from world_modelz_tpu.train.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.cli import import_torch_sparse as pits  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.train import restore_checkpoint  # noqa: E402

SHAPE, K, N = (4, 4, 4), 16, 24
MODEL = dict(dim=32, num_classes=K, depth=2, dim_head=16, mlp_dim=24, heads=2)


def _pth(path, params, ema=None, **opt):
    def sd_(p):
        return {k: v.clone() for k, v in convert.sparse_state_dict_from_params(p).items()}

    ckpt = {"step": 7, "model_state_dict": sd_(params), "opt": argparse.Namespace(**opt)}
    if ema is not None:
        ckpt["ema_model_state_dict"] = sd_(ema)
    torch.save(ckpt, path)
    return str(path)


def _params(moe_experts, seed):
    jm = JaxSparse(shape=SHAPE, attn_backend="xla", moe_experts=moe_experts, **MODEL)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, N), jnp.int32),
        jnp.zeros((1, N), jnp.int32))["params"])
    return jm, params


def _inputs():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, K + 1, size=(2, N)).astype(np.int32)
    indices = np.stack([rng.permutation(64)[:N] for _ in range(2)]).astype(np.int32)
    return tokens, indices


def _port_logits(state, cfg, part, tokens, indices):
    pcfg = sd.SparseDiffusionConfig(**{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in cfg.items()})
    model = sd.make_model(pcfg, K, "cpu").eval()
    model.load_state_dict(state[part], strict=True)
    with torch.no_grad():
        return model(torch.from_numpy(tokens), torch.from_numpy(indices)).numpy()


def test_dense_import_equals_jax_importer(tmp_path):
    jm, params = _params(0, 5)
    ema = jax.tree_util.tree_map(lambda x: x * 0.5, params)
    pth = _pth(tmp_path / "sparse.pth", params, ema, heads=2, num_context=N, ema_decay=0.99,
               name="refsparse")
    jpath = jits.run(jits.ImportTorchSparseConfig(
        torch_checkpoint=pth, output_dir=str(tmp_path / "jax"), image_size=16))
    ppath = pits.run(pits.ImportTorchSparseConfig(
        torch_checkpoint=pth, output_dir=str(tmp_path / "port"), image_size=16))
    jstate, jstep, jcfg = jax_restore(jpath)
    state, step, cfg = restore_checkpoint(ppath)
    assert step == jstep == 7
    for key in ("S", "H", "W", "dim", "mlp_dim", "heads", "depth", "num_context",
                "ema_decay", "name", "moe_experts"):
        assert cfg[key] == jcfg[key], key
    assert state["opt_state"] == {} and set(state["sampler"]) >= {"weights", "counts"}
    tokens, indices = _inputs()
    for part in ("params", "ema"):
        want_sd = convert.sparse_state_dict_from_params(jax.device_get(jstate[part]))
        assert set(want_sd) == set(state[part])
        for k, v in want_sd.items():
            assert torch.equal(state[part][k], v), (part, k)
        want = np.asarray(jm.apply({"params": jstate[part]}, tokens, indices))
        np.testing.assert_allclose(_port_logits(state, cfg, part, tokens, indices), want,
                                   rtol=0, atol=1e-5, err_msg=part)


def test_moe_import_gives_jax_logits(tmp_path):
    jm, params = _params(2, 6)
    pth = _pth(tmp_path / "moe.pth", params, heads=2, num_context=N)
    with pytest.raises(KeyError):  # the JAX importer reads no MoE keys
        jits.run(jits.ImportTorchSparseConfig(torch_checkpoint=pth,
                                              output_dir=str(tmp_path / "jax")))
    path = pits.run(pits.ImportTorchSparseConfig(torch_checkpoint=pth,
                                                 output_dir=str(tmp_path / "port")))
    state, step, cfg = restore_checkpoint(path)
    assert step == 7 and cfg["moe_experts"] == 2 and cfg["mlp_dim"] == MODEL["mlp_dim"]
    assert state["ema"] == {} and cfg["ema_decay"] == 0.0
    tokens, indices = _inputs()
    want = np.asarray(jm.apply({"params": params}, tokens, indices))
    np.testing.assert_allclose(_port_logits(state, cfg, "params", tokens, indices), want,
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="torch_checkpoint"):
        pits.run(pits.ImportTorchSparseConfig())
