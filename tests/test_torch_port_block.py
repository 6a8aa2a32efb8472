"""Port parity: the whole-block fused local-3D attention
(``world_modelz_tpu_torch.kernels.local3d_block`` and ``backend="fused"``
of the attention, the denoiser and the trainer) against the JAX package.

The JAX side runs as tests/test_kernels.py runs it on the CPU: the Pallas
kernel in interpret mode, and the plain XLA composition. Everything is f32
unless said otherwise. Tolerances:
- the block's plain version against JAX: 1e-5 x max(1, max |ref|) — the
  same f32 products and masked softmax summed in another order;
- bf16: 2e-2 x max(1, max |ref|) — bf16's 2^-8 rounding at the same
  points (q, k, v, P, the attention output, the output);
- the eight operand gradients, on tests/test_kernels.py's unit-normal
  weights: 3e-5 x max(1, max |grad|). Those weights give scores of
  standard deviation ~24, a nearly saturated softmax, where JAX's own f32
  gradient lies up to 1.25e-5 (relative) off float64 and the port's up to
  3.2e-6;
- module and model values and gradients 1e-5 (logits 1e-4 after a 2-layer
  stack, as tests/test_torch_port_attention.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.diffusion import masked as jmasked  # noqa: E402
from world_modelz_tpu.kernels import local3d_block as jblock  # noqa: E402
from world_modelz_tpu.models import attention as jattn  # noqa: E402
from world_modelz_tpu.models.video import (  # noqa: E402
    VqVideoDiffusionModel as JaxDenoiser,
)
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.diffusion import rollout_frames  # noqa: E402
from world_modelz_tpu_torch.kernels import (  # noqa: E402
    block_supported,
    local3d_block,
    local3d_block_fwd,
    local3d_block_reference,
)
from world_modelz_tpu_torch.kernels.local3d_block import (  # noqa: E402
    _band_candidates,
    _kernel_args,
    fits_vmem_block,
)
from world_modelz_tpu_torch.models import (  # noqa: E402
    VQAutoEncoder,
    VqVideoDiffusionModel,
)
from world_modelz_tpu_torch.models import attention as tattn  # noqa: E402

BLOCK_TOL = 1e-5
BF16_TOL = 2e-2
GRAD_TOL = 3e-5
MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4


def _operands(seed, b=2, s=4, h=4, w=4, dim=24, heads=2, dh=8,
              weight_scale=False):
    """The operands of tests/test_kernels.py's ``_block_operands`` in the
    JAX layout (weights (in, out)); ``weight_scale`` scales each weight by
    fan_in^-1/2 so that activations stay O(1)."""
    rng = np.random.default_rng(seed)
    inner = heads * dh

    def f(*shape, fan_in=1):
        scale = fan_in**-0.5 if weight_scale else 1.0
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return (f(b, s, h, w, dim), f(b, s, h, w, dim), f(dim, inner, fan_in=dim),
            f(dim, inner, fan_in=dim), f(inner, fan_in=dim),
            f(dim, inner, fan_in=dim), f(inner, dim, fan_in=inner),
            f(dim, fan_in=inner))


def _port(ops, dtype=torch.float32):
    """JAX-layout numpy operands -> the port's (nn.Linear layout) tensors."""
    x, q, wk, wv, bv, wq, wo, bo = (torch.from_numpy(a).to(dtype) for a in ops)
    return [x, q, wk.T.contiguous(), wv.T.contiguous(), bv, wq.T.contiguous(),
            wo.T.contiguous(), bo]


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    lim = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= lim, (err, lim)


# (seed, operand shape kwargs, extents, heads): the shapes of
# test_local3d_block_matches_composition, of the banded 16x16 case and of
# test_local3d_block_gradients_match_composition
BLOCK_CASES = [
    (0, dict(), (1, 1, 1), 2),
    (1, dict(b=1, s=3, h=16, w=16, dim=16, heads=1, dh=16), (1, 1, 1), 1),
    (2, dict(s=5, heads=1, dh=16), (2, 1, 1), 1),
]


@pytest.mark.parametrize("seed,shape,extents,heads", BLOCK_CASES)
def test_block_reference_matches_pallas_interpret_and_composition(
        seed, shape, extents, heads):
    ops = _operands(seed, **shape)
    jops = [jnp.asarray(a) for a in ops]
    kernel = np.asarray(jblock.local3d_block(*jops, extents, heads, True))
    composed = np.asarray(jblock._block_reference(*jops, extents, heads))
    got = local3d_block_reference(*_port(ops), extents, heads)
    assert got.dtype == torch.float32
    _close(got.numpy(), kernel, BLOCK_TOL)
    _close(got.numpy(), composed, BLOCK_TOL)
    # the wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(
        local3d_block_fwd(*_port(ops), extents, heads).numpy(), got.numpy())


def test_block_reference_in_bf16_keeps_the_kernels_rounding_points():
    ops = _operands(3, weight_scale=True)
    jops = [jnp.asarray(a, jnp.bfloat16) for a in ops]
    ref = jblock.local3d_block(*jops, (1, 1, 1), 2, True)
    assert ref.dtype == jnp.bfloat16
    got = local3d_block_reference(*_port(ops, torch.bfloat16), (1, 1, 1), 2)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref, np.float32), BF16_TOL)


def test_block_gradients_match_jax_custom_vjp():
    """The eight operand gradients of the port's Function against jax.grad
    through the JAX custom_vjp (interpret), with a fixed cotangent."""
    extents, heads = (2, 1, 1), 1
    ops = _operands(4, s=5, heads=1, dh=16)
    cot = np.random.default_rng(5).normal(size=(2, 5, 4, 4, 24)).astype(np.float32)

    def loss(*o):
        return jnp.sum(jblock.local3d_block(*o, extents, heads, True) * cot)

    want = jax.grad(loss, argnums=tuple(range(8)))(*[jnp.asarray(a) for a in ops])
    leaves = [t.requires_grad_() for t in _port(ops)]
    out = local3d_block(*leaves, extents, heads)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    transposed = {2, 3, 5, 6}  # weights: the port's layout is JAX's, transposed
    for i, (g, ref) in enumerate(zip(got, want)):
        g = g.numpy().T if i in transposed else g.numpy()
        _close(g, np.asarray(ref), GRAD_TOL)


def test_block_function_passes_float64_gradcheck():
    gen = torch.Generator().manual_seed(6)

    def r(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    ops = (r(1, 3, 2, 3, 8), r(1, 3, 2, 3, 8), r(64, 8), r(64, 8), r(64),
           r(64, 8), r(8, 64), r(8))
    assert torch.autograd.gradcheck(
        lambda *o: local3d_block(*o, (1, 1, 1), 2), ops)


def _jax_module_params(module, x, q):
    return jax.device_get(module.init(jax.random.PRNGKey(0), x, q)["params"])


def _module_state(params):
    sd = {}
    for proj in ("to_q", "to_k", "to_v"):
        convert._linear(sd, proj, params[proj])
    if "to_out" in params:
        convert._linear(sd, "to_out.0", params["to_out"])
    return sd


@pytest.mark.parametrize("heads,dim_head,extents", [(1, 12, (1, 1, 1)),
                                                    (2, 8, (1, 2, 1))])
def test_fused_module_matches_jax_fused_module(heads, dim_head, extents):
    """Local3dAttention(backend='fused') against JAX's, values and
    parameter gradients of sum(out ** 2), params carried by convert."""
    dim, (b, s, h, w) = 20, (2, 3, 4, 4)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, s, h, w, dim)).astype(np.float32)
    q = rng.normal(size=(b, s, h, w, dim)).astype(np.float32)
    jm = jattn.Local3dAttention(extents=extents, heads=heads, dim_head=dim_head,
                                backend="fused")
    params = _jax_module_params(jm, jnp.asarray(x), jnp.asarray(q))

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(q)) ** 2)

    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(q)))
    jgrads = jax.grad(loss)(params)
    pm = tattn.Local3dAttention(dim, extents, heads=heads, dim_head=dim_head,
                                backend="fused")
    pm.load_state_dict(_module_state(params), strict=True)
    out = pm(torch.from_numpy(x), torch.from_numpy(q))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=MODULE_TOL, rtol=0)
    (out ** 2).sum().backward()
    want = _module_state(jax.device_get(jgrads))
    for name, p in pm.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), MODULE_TOL)


DEN = dict(data_shape=(3, 4, 4), dim=32, num_classes=16, extents=(1, 2, 1),
           depth=2, dim_head=16, mlp_dim=24, heads=2)


@pytest.fixture(scope="module")
def denoisers():
    """JAX's fused denoiser and the port's, on the same weights."""
    jm = JaxDenoiser(**DEN, backend="fused")
    s, h, w = DEN["data_shape"]
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, s, h, w), jnp.int32))["params"]
    rng = np.random.default_rng(8)  # non-trivial LayerNorm and bias values
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        params)
    pm = VqVideoDiffusionModel(**DEN, backend="fused", device="cpu")
    pm.load_state_dict(convert.video_state_dict_from_params(params), strict=True)
    return jm, params, pm


def test_fused_denoiser_logits_match_flax(denoisers):
    jm, params, pm = denoisers
    s, h, w = DEN["data_shape"]
    tokens = np.random.default_rng(9).integers(
        0, DEN["num_classes"] + 1, size=(2, s, h, w)).astype(np.int32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = pm(torch.from_numpy(tokens))
    assert all(layer[0].fn.backend == "fused" for layer in pm.transformer.layers)
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_TOL, rtol=0)


def _jax_draws(key, num_frames, num_iterations, b, hw, k):
    """(gumbel, uniform) in the key order of JAX's rollout_frames, as
    tests/test_torch_port_serve.py replays them."""
    draws = {}
    for t in range(num_frames):
        key, sub = jax.random.split(key)
        for i in range(num_iterations):
            sub, k_draw, k_mask = jax.random.split(sub, 3)
            g = jax.random.gumbel(k_draw, (b * hw[0] * hw[1], k), jnp.float32)
            u = jax.random.uniform(k_mask, (b, *hw))
            draws[t, i] = (torch.from_numpy(np.array(g)), torch.from_numpy(np.array(u)))
    return lambda t, i: draws[t, i]


def test_fused_rollout_tokens_match_jax_under_its_noise(denoisers):
    jm, params, pm = denoisers
    s, h, w = DEN["data_shape"]
    k = DEN["num_classes"]
    ctx = np.random.default_rng(10).integers(0, k, size=(2, s, h, w)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    kw = dict(num_frames=2, num_classes=k, mask_token=k, num_iterations=3,
              sample_topk=-1)
    ref = np.asarray(jmasked.rollout_frames(
        key, lambda z: jm.apply({"params": params}, z), jnp.asarray(ctx), **kw))
    with torch.no_grad():
        got = rollout_frames(pm, torch.from_numpy(ctx),
                             noise=_jax_draws(key, 2, 3, 2, (h, w), k), **kw)
    np.testing.assert_array_equal(got.numpy(), ref)


S, IMG, C, K, B = 3, 16, 1, 16, 2
GRID = IMG // 4
TOK_CFG = dict(embedding_dim=8, num_embeddings=K, downscale_steps=2,
               hidden_planes=8, in_channels=C)


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    torch.manual_seed(0)
    tok = VQAutoEncoder(**TOK_CFG, device="cpu")
    return ptrain.save_checkpoint(
        str(tmp_path_factory.mktemp("ptok")), 0, {"tokenizer": tok.state_dict()},
        TOK_CFG)


def _cfg(tok_path, out, **kw):
    return vd.VideoDiffusionConfig(**dict(dict(
        platform="cpu", decoder_model=tok_path, output_dir=str(out),
        batch_size=B, n_past=S - 1, image_size=IMG, digit_size=6, dim=32,
        depth=2, mlp_dim=24, dim_head=16, heads=2, extents=(1, 1, 1),
        warmup=2, max_steps=2, eval_interval=0, checkpoint_interval=2,
        log_interval=1, ema_decay=0.9, lr=1e-3, tok_bf16=False), **kw))


def test_fused_train_step_equals_the_auto_step(tok_path, tmp_path):
    """One CPU train step of the fused denoiser against the 'auto' one from
    the same weights, batch and draws: loss, grad norm, parameters, EMA."""
    cfg = _cfg(tok_path, tmp_path)
    tok, _ = vd.load_tokenizer(tok_path, "cpu")
    states = {}
    for backend in ("auto", "fused"):
        torch.manual_seed(12)
        model = vd.make_model(cfg, (S, GRID, GRID), K, "cpu", backend)
        assert model.transformer.layers[0][0].fn.backend == backend
        state = vd.init_state(cfg, model)
        frames = torch.from_numpy(np.random.default_rng(13).integers(
            0, 256, size=(B, S, IMG, IMG, C)).astype(np.uint8))
        draws = vd.draw_step(torch.Generator().manual_seed(14), B, GRID * GRID,
                             state.sampler.weights.shape[0], K)
        states[backend] = (state, vd.train_step(state, tok, frames, cfg, draws))
    (auto, (loss_a, gn_a, ok_a)), (fused, (loss_f, gn_f, ok_f)) = (
        states["auto"], states["fused"])
    assert ok_a and ok_f
    assert abs(loss_a - loss_f) <= 1e-6 * max(1.0, abs(loss_a))
    assert abs(gn_a - gn_f) <= 1e-6 * max(1.0, gn_a)
    for (name, pa), (_, pf) in zip(auto.model.named_parameters(),
                                   fused.model.named_parameters()):
        torch.testing.assert_close(pf, pa, rtol=0, atol=1e-6, msg=name)
        torch.testing.assert_close(fused.ema[name], auto.ema[name], rtol=0,
                                   atol=1e-6, msg=name)


def test_trainer_runs_the_fused_denoiser(tok_path, tmp_path):
    result = vd.train(_cfg(tok_path, tmp_path, bf16=True), backend="fused")
    assert result.rejected == 0 and result.state.step == 2
    assert all(np.isfinite(h[1]) for h in result.history)
    assert result.state.model.transformer.layers[1][0].fn.backend == "fused"
    assert ptrain.latest_checkpoint(str(tmp_path)).endswith("step_0000002")


# (seq, height, width, extents, heads, dh, dim): the m3 shapes at 8x8 and
# 16x16, the 32x32 grid the JAX package turns away, and shapes near the
# budget's edge and the S * heads <= 64 unroll limit
GATE_SHAPES = [
    (6, 8, 8, (3, 1, 1), 1, 128, 384),
    (6, 16, 16, (3, 1, 1), 1, 128, 384),
    (16, 32, 32, (3, 1, 1), 1, 128, 384),
    (6, 16, 16, (3, 1, 1), 2, 64, 384),
    (6, 16, 16, (1, 2, 1), 4, 64, 512),
    (16, 16, 16, (3, 3, 3), 1, 128, 256),
    (8, 8, 8, (1, 1, 1), 8, 64, 512),
    (9, 8, 8, (1, 1, 1), 8, 32, 128),
    (32, 8, 8, (2, 1, 1), 2, 64, 384),
    (33, 8, 8, (2, 1, 1), 2, 64, 384),
    (12, 24, 24, (2, 2, 2), 1, 64, 192),
    (4, 32, 32, (1, 1, 1), 1, 64, 128),
]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", GATE_SHAPES, ids=lambda s: "x".join(map(str, s[:3]))
                         + f"_e{''.join(map(str, s[3]))}_h{s[4]}x{s[5]}_d{s[6]}")
def test_block_gate_matches_jax(shape, itemsize):
    seq, h, w, ext, heads, dh, dim = shape
    args = (seq, h, w, ext, heads, dh, dim, dim, itemsize)
    assert block_supported(*args) == jblock.block_supported(*args)
    assert fits_vmem_block(*args) == jblock.fits_vmem_block(*args)


def test_block_gate_named_cases():
    assert block_supported(6, 16, 16, (3, 1, 1), 1, 128, 384, 384, 2)
    assert not block_supported(16, 32, 32, (3, 1, 1), 1, 128, 384, 384, 2)
    assert not block_supported(6, 16, 16, (3, 1, 1), 1, 128, 384, 384, 4)
    assert _band_candidates(8, 8, 1) == [8]
    assert _band_candidates(16, 16, 1) == [8, 16]


def test_fused_backend_raises_where_jax_does():
    x = torch.zeros(1, 2, 4, 4, 16)
    no_out = tattn.Local3dAttention(16, (1, 1, 1), heads=1, dim_head=16,
                                    backend="fused")
    assert no_out.to_out is None
    with pytest.raises(ValueError, match="no output projection"):
        no_out(x, x)
    # the m3 block in f32 at 6x16x16 exceeds the JAX package's budget
    big = tattn.Local3dAttention(384, (3, 1, 1), heads=1, dim_head=128,
                                 backend="fused")
    x = torch.zeros(1, 6, 16, 16, 384)
    with pytest.raises(ValueError, match="unsupported for grid 16x16 S=6"):
        big(x, x)
    with pytest.raises(ValueError, match="backend"):
        tattn.Local3dAttention(16, (1, 1, 1), backend="triton")
    with pytest.raises(ValueError, match="backend"):
        VqVideoDiffusionModel(**DEN, backend="flash", device="cpu")


def test_block_wrapper_checks_its_arguments():
    ops = _port(_operands(15, b=1, s=2, h=2, w=2, dim=64, heads=1, dh=32))
    with pytest.raises(ValueError, match="x_kv and q_in"):
        local3d_block_fwd(ops[0], ops[1][:, :1], *ops[2:], (1, 1, 1), 1)
    with pytest.raises(ValueError, match="wo must be"):
        local3d_block_fwd(*ops[:6], ops[6][:, :16], ops[7], (1, 1, 1), 1)
    with pytest.raises(ValueError, match="heads"):
        local3d_block_fwd(*ops, (1, 1, 1), 3)
    # a tensor on neither the CPU nor CUDA: no silent plain version
    meta = [torch.empty(t.shape, device="meta") for t in ops]
    with pytest.raises(ValueError, match="CUDA"):
        local3d_block_fwd(*meta, (1, 1, 1), 1)
    # what the CUDA kernel does not take, checked before a launch
    args = _kernel_args((1, 1, 1), 1, ops)
    assert args == (1, 2, 2, 2, 1, 32, 64, 64, 64, 1, 1, 1, 0)
    with pytest.raises(TypeError, match="one dtype"):
        _kernel_args((1, 1, 1), 1, [ops[0].double(), *ops[1:]])
    with pytest.raises(ValueError, match="dim_head"):
        _kernel_args((1, 1, 1), 2, ops)  # dim_head 16
    with pytest.raises(ValueError, match="extents"):
        _kernel_args((1, -1, 1), 1, ops)
    strided = ops[0].transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        _kernel_args((1, 1, 1), 1, [strided, *ops[1:]])
    odd = _port(_operands(16, b=1, s=2, h=2, w=2, dim=6, heads=1, dh=32))
    with pytest.raises(ValueError, match="% 4"):
        _kernel_args((1, 1, 1), 1, odd)


def test_state_dict_is_the_same_for_every_backend():
    sds = {}
    for backend in tattn.LOCAL3D_BACKENDS:
        torch.manual_seed(17)
        sds[backend] = VqVideoDiffusionModel(**DEN, backend=backend,
                                             device="cpu").state_dict()
    ref = sds["auto"]
    for backend, sd in sds.items():
        assert list(sd) == list(ref), backend
        for key in ref:
            assert torch.equal(sd[key], ref[key]), (backend, key)


def test_xla_backend_is_the_plain_composition():
    """backend='xla' runs the plain local3d_attention; on the CPU every
    backend gives the same logits."""
    torch.manual_seed(18)
    models = {b: VqVideoDiffusionModel(**DEN, backend=b, device="cpu")
              for b in tattn.LOCAL3D_BACKENDS}
    for m in models.values():
        m.load_state_dict(models["auto"].state_dict())
    s, h, w = DEN["data_shape"]
    tokens = torch.randint(0, DEN["num_classes"] + 1, (2, s, h, w),
                           generator=torch.Generator().manual_seed(19))
    with torch.no_grad():
        ref = models["auto"](tokens)
        for backend, m in models.items():
            torch.testing.assert_close(m(tokens), ref, rtol=0, atol=MODULE_TOL,
                                       msg=backend)


def test_config_has_no_backend_field():
    """The backend is a Python keyword of train and make_model, not a
    config field or CLI flag (the JAX trainer has none)."""
    assert "backend" not in {f.name for f in dataclasses.fields(vd.VideoDiffusionConfig)}
