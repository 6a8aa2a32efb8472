"""Port parity: two places where the port once computed differently from
the JAX package, each held to JAX.

- Biased dense layers in bf16. JAX's ``_dense_apply`` and flax's
  ``nn.Dense`` round the product to bf16, then add the bias in bf16;
  ``F.linear`` with a bias adds it inside the product and rounds once,
  which leaves ~29% of bf16 outputs one rounding step apart. Every biased
  dense layer of the port is held to its JAX counterpart element by
  element: at least 99% bitwise equal, none more than one bf16 step apart,
  a step taken at the larger of the output and the product (the f32 sums
  of the product run in another order, which may still move its rounding,
  and the bias may then cancel most of it).
- Serving mode. The JAX service applies the tokenizer and the denoiser
  with ``train=False`` (world_modelz_tpu/serve.py:192-196) whatever the
  caller trains; ``RolloutService`` over train-mode modules with dropout
  must give the eval-mode tokens and pixels under the same generator, and
  leave every submodule's mode as it found it.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.models.attention import _dense_apply  # noqa: E402
from world_modelz_tpu_torch.models import (  # noqa: E402
    VQAutoEncoder,
    VqSparseDiffusionModel,
    VqVideoDiffusionModel,
)
from world_modelz_tpu_torch.models import attention as pa  # noqa: E402
from world_modelz_tpu_torch.ops.dense import dense_apply  # noqa: E402
from world_modelz_tpu_torch.serve import RolloutService  # noqa: E402

EQUAL_FRACTION = 0.99  # bitwise-equal bf16 outputs, at least
ROWS = 512


def _flax_dense(x, kernel, bias):
    return fnn.Dense(kernel.shape[1]).apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)


# name -> (the port's layer from a module of its own, the JAX apply of its
# counterpart): Local3dAttention's to_v and to_out are _dense_apply
# (attention.py:494-497), the rest flax nn.Dense (attention.py:56-59, 230;
# video.py:66, 106)
LAYERS = {
    "local3d_to_v": (lambda: pa.Local3dAttention(96, (1, 1, 1), heads=2, dim_head=64).to_v,
                     _dense_apply),
    "local3d_to_out": (lambda: pa.Local3dAttention(96, (1, 1, 1), heads=2,
                                                   dim_head=64).to_out[0], _dense_apply),
    "dense_to_out": (lambda: pa.DenseAttention(96, heads=2, dim_head=64).to_out[0],
                     _flax_dense),
    "feedforward_in": (lambda: pa.FeedForward(96, 160).net[0], _flax_dense),
    "feedforward_out": (lambda: pa.FeedForward(96, 160).net[3], _flax_dense),
    "video_logit_proj": (lambda: VqVideoDiffusionModel(
        (2, 2, 2), 96, 80, (1, 1, 1), 1, 16, 16, device="cpu").logit_proj, _flax_dense),
    "sparse_logit_proj": (lambda: VqSparseDiffusionModel(
        (2, 2, 2), 96, 80, 1, 16, 16, device="cpu").logit_proj, _flax_dense),
}


def _bf16_step(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers (8 significant bits) at magnitude |a|."""
    exp = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_biased_dense_layer_rounds_the_product_before_the_bias_as_jax(name):
    make, jax_apply = LAYERS[name]
    layer = make()
    fan_out, fan_in = layer.weight.shape
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(ROWS, fan_in)).astype(np.float32)
    w = (rng.normal(size=(fan_out, fan_in)) / np.sqrt(fan_in)).astype(np.float32)
    b = rng.normal(size=(fan_out,)).astype(np.float32)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
    layer.to(torch.bfloat16)
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    want = np.asarray(jax_apply(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w.T, b)))
                      .astype(jnp.float32))
    assert got.shape == want.shape == (ROWS, fan_out)
    equal = float((got == want).mean())
    assert equal >= EQUAL_FRACTION, f"{name}: {equal:.4f} of outputs bitwise equal"
    bf = [torch.from_numpy(a).to(torch.bfloat16).double().numpy() for a in (x, w)]
    step = _bf16_step(np.maximum(np.abs(want), np.abs(bf[0] @ bf[1].T)))
    apart = float((np.abs(got - want) / step).max())
    assert apart <= 1, f"{name}: outputs {apart} bf16 steps apart"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_apply_keeps_the_bias_inside_the_product_from_f32_up(dtype):
    """In f32 and wider the product is already in the working dtype, so
    ``dense_apply`` hands the bias to ``F.linear`` (no separate add):
    bitwise nn.Linear."""
    rng = np.random.default_rng(7)
    x, w, b = (torch.from_numpy(rng.normal(size=shape)).to(dtype)
               for shape in ((ROWS, 96), (160, 96), (160,)))
    want = torch.nn.functional.linear(x, w, b)
    assert torch.equal(dense_apply(x, w, b), want)
    low = x.to(torch.bfloat16)  # promoted to the parameters' dtype, as flax does
    assert torch.equal(dense_apply(low, w, b), torch.nn.functional.linear(low.to(dtype), w, b))


S, IMG, K, D = 3, 16, 16, 8
TH = IMG // 4


def test_service_runs_train_mode_modules_in_eval_mode_and_restores_them():
    """A tokenizer and a denoiser (dropout 0.5) left in train mode sample
    what the same modules in eval mode sample, through open_session (the
    encode program) and generate (the rollout program)."""
    torch.manual_seed(0)
    tok = VQAutoEncoder(D, K, 2, 8, 1, device="cpu")
    model = VqVideoDiffusionModel((S, TH, TH), 16, K, (1, 1, 1), 2, 8, 16, heads=2,
                                  dropout=0.5, device="cpu")
    clip = np.random.default_rng(0).uniform(size=(S, IMG, IMG, 1)).astype(np.float32)
    runs = {}
    for training in (False, True):
        tok.train(training)
        model.train(training)
        stats = [b.clone() for b in tok.buffers()]
        with RolloutService(tok, model, num_frames=2, num_iterations=3, seed=0,
                            device="cpu") as svc:
            sess = svc.open_session(clip)
            seed_tokens = sess._ctx.copy()
            pixels = sess.generate()
            runs[training] = (seed_tokens, sess._ctx, pixels)
        assert all(m.training == training for m in (*tok.modules(), *model.modules()))
        assert all(torch.equal(a, b) for a, b in zip(stats, tok.buffers()))
    for eval_run, train_run in zip(runs[False], runs[True]):
        np.testing.assert_array_equal(train_run, eval_run)
