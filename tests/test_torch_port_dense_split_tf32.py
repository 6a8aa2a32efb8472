"""The f32 dense layers' split-TF32 kernel (``csrc/dense_tf32.cu``): its
plain version against float64, the route that sends layers to it
(``ops.dense.tf32_route``), the wrapper's checks, and the models around it
on the CPU, where the route never engages.

The plain version (``kernels.dense_tf32.dense_tf32_reference``) takes each
8-deep step's three TF32 products (operands split as ``cvt.rna``) and adds
their sum to the running sum in f32, as the kernel does. Bound, on the
error over max(1, |Y|) against the float64 product with its epilogue, at
the served denoiser's shapes (M = 384 b rows for b in {1, 2, 4, 8}; (N,
K) of the projections, the MLP and the output projection): 16 f32 ulps of
1.0 (2^-19). The plain version reads 0.5e-6 to 1.2e-6 there, under the
plain f32 product's own 1.5e-6 to 3.1e-6 (torch 2.x on this CPU); one
TF32 product a step, the design the kernel does not take, reads ~1.4e-3,
hundreds of times over the bound.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from world_modelz_tpu_torch.kernels import LAUNCHES
from world_modelz_tpu_torch.kernels import dense_tf32 as kd
from world_modelz_tpu_torch.models import VqSparseDiffusionModel, VqVideoDiffusionModel
from world_modelz_tpu_torch.models import attention
from world_modelz_tpu_torch.ops.dense import dense_apply, tf32_route

SPLIT_TOL = 2.0**-19  # 16 ulps of 1.0 in f32
ROWS = (384, 768, 1536, 3072)  # M = 384 b, b in the serving ladder [1, 2, 4, 8]
SHAPES = ((128, 384), (384, 128), (512, 384), (384, 512))  # (N, K)


def _operands(m, n, k, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    w = torch.randn((n, k), generator=g) * k**-0.5
    b = torch.randn((n,), generator=g) * 0.1
    r = torch.randn((m, n), generator=g)
    return x, w, b, r


def _f64(x, w, b, epi, r):
    y = x.double() @ w.double().T + b.double()
    if epi == "gelu":
        y = F.gelu(y, approximate="tanh")
    return y + r.double() if epi == "residual" else y


def _scaled_err(y, want):
    return ((y.double() - want).abs() / want.abs().clamp(min=1.0)).max().item()


@pytest.mark.parametrize("epi", ["none", "gelu", "residual"])
@pytest.mark.parametrize("nk", SHAPES, ids=lambda nk: f"n{nk[0]}k{nk[1]}")
@pytest.mark.parametrize("m", ROWS)
def test_split_arithmetic_within_bound_of_f64(m, nk, epi):
    n, k = nk
    x, w, b, r = _operands(m, n, k, seed=m + n + k)
    y = kd.dense_tf32_reference(x, w, b, gelu=epi == "gelu",
                                residual=r if epi == "residual" else None)
    assert y.dtype == torch.float32 and y.shape == (m, n)
    assert _scaled_err(y, _f64(x, w, b, epi, r)) <= SPLIT_TOL


@pytest.mark.parametrize("nk", SHAPES, ids=lambda nk: f"n{nk[0]}k{nk[1]}")
def test_one_tf32_product_misses_the_bound(nk):
    """The design not taken: one TF32 product (hi_x hi_w) a step."""
    n, k = nk
    x, w, b, r = _operands(ROWS[0], n, k, seed=n * k)
    xh, wh = kd.tf32(x), kd.tf32(w)
    s = torch.zeros((x.shape[0], n))
    for k0 in range(0, k, kd.STEP):
        s = s + xh[:, k0:k0 + kd.STEP] @ wh[:, k0:k0 + kd.STEP].T
    assert _scaled_err(s + b, _f64(x, w, b, "none", r)) >= 100 * SPLIT_TOL


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0**-10  # of a TF32 number in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-20, 1 + 3 * ulp / 2,
                      float("inf"), float("-inf")])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, float("inf"), float("-inf")])
    assert torch.equal(kd.tf32(x), want)
    assert torch.isnan(kd.tf32(torch.tensor([float("nan")]))).all()
    hi, lo = kd.split(torch.tensor([1 + 2.0**-15]))
    assert hi.item() == 1.0 and lo.item() == 2.0**-15


def test_group_is_each_layer_and_counts_no_launch_on_the_cpu():
    x, w, b, _ = _operands(96, 128, 64, seed=1)
    x2, w2, _, _ = _operands(96, 64, 64, seed=2)
    before = LAUNCHES["dense_tf32"]
    got = kd.dense_tf32_group([(x, w, None), (x2, w2, None), (x2, w, b)])
    want = [kd.dense_tf32_reference(*p) for p in ((x, w), (x2, w2), (x2, w, b))]
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert torch.equal(kd.dense_tf32(x, w, b, gelu=True),
                       kd.dense_tf32_reference(x, w, b, gelu=True))
    assert LAUNCHES["dense_tf32"] == before


def test_wrapper_checks_raise():
    x, w, b, r = _operands(8, 16, 24, seed=3)
    with pytest.raises(TypeError, match="float32"):
        kd.dense_tf32(x.bfloat16(), w)
    with pytest.raises(ValueError, match="multiple of 8"):
        kd.dense_tf32(x[:, :20].contiguous(), w[:, :20].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kd.dense_tf32(x.T.contiguous().T, w)
    with pytest.raises(ValueError, match="expected x"):
        kd.dense_tf32(x, w.T.contiguous())
    with pytest.raises(ValueError, match="bias"):
        kd.dense_tf32(x, w, b[:8])
    with pytest.raises(ValueError, match="residual"):
        kd.dense_tf32(x, w, b, residual=r[:4])
    with pytest.raises(ValueError, match="not both"):
        kd.dense_tf32(x, w, b, gelu=True, residual=r)
    with pytest.raises(ValueError, match="1 to 3"):
        kd.dense_tf32_group([(x, w, None)] * 4)
    with pytest.raises(ValueError, match="shapes"):
        kd.dense_tf32_group([(x, w, None), (x[:4], w, None)])
    with pytest.raises(ValueError, match="CUDA device"):
        kd.dense_tf32(x.to("meta"), w)


class _Operand(types.SimpleNamespace):
    """The attributes ``tf32_route`` reads, for a tensor said to lie on a
    CUDA device (this host has none)."""

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self.contiguous

    def data_ptr(self):
        return self.ptr


def _fake(shape, dtype=torch.float32, contiguous=True, ptr=256, is_cuda=True):
    return _Operand(shape=torch.Size(shape), dtype=dtype, contiguous=contiguous, ptr=ptr,
                    is_cuda=is_cuda)


@pytest.mark.parametrize("case", [
    "taken", "cpu", "bf16", "bf16_weight", "f64", "grad", "attached", "ragged_k",
    "strided_x", "strided_w", "misaligned", "mismatch"])
def test_route_predicate(case):
    x, w = dict(
        cpu=(_fake((4, 384), is_cuda=False), _fake((128, 384))),
        bf16=(_fake((4, 384), torch.bfloat16), _fake((128, 384), torch.bfloat16)),
        bf16_weight=(_fake((4, 384)), _fake((128, 384), torch.bfloat16)),
        f64=(_fake((4, 384), torch.float64), _fake((128, 384))),
        ragged_k=(_fake((4, 36)), _fake((128, 36))),
        strided_x=(_fake((4, 384), contiguous=False), _fake((128, 384))),
        strided_w=(_fake((4, 384)), _fake((128, 384), contiguous=False)),
        misaligned=(_fake((4, 384), ptr=260), _fake((128, 384))),
        mismatch=(_fake((4, 392)), _fake((128, 384))),
    ).get(case, (_fake((4, 384)), _fake((128, 384))))
    with torch.set_grad_enabled(case == "grad"):
        got = tf32_route(x, w, attached=case == "attached")
    # a bf16 input with f32 weights promotes to f32: taken, as dense_apply promotes it
    assert got == (case in ("taken", "bf16_weight")), case
    assert not tf32_route(torch.zeros(4, 384), torch.zeros(128, 384))


VIDEO = dict(data_shape=(3, 4, 4), dim=32, num_classes=24, extents=(1, 1, 1), depth=2,
             dim_head=16, mlp_dim=48, heads=2)
SPARSE = dict(shape=(3, 4, 4), dim=32, num_classes=24, depth=2, dim_head=16, mlp_dim=48,
              heads=2)


def _video_before(model, tokens):
    """``VqVideoDiffusionModel.forward`` as it was before the route: each
    block's skip added after the module, logits through ``Dense``."""
    t = model.transformer
    _, s, h, w = tokens.shape
    x = t.embedding(tokens.long()) + t.get_pos_embedding(s, h, w)[None]
    for attn, ff in t.layers:
        x = attn(x, q=x) + x
        x = ff(x) + x
    return model.logit_proj(x[:, -1])


def _sparse_before(model, tokens, indices):
    x = model.embedding(tokens.long()) + model.pos_embedding_3d(indices.long())
    for attn, ff in model.transformer.layers:
        x = attn(x) + x
        x = ff(x) + x
    return model.logit_proj(x)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference"])
def test_models_on_the_cpu_bitwise_as_before(mode):
    """On the CPU the route never engages: both denoisers return bitwise
    what they returned before it, in training and in evaluation."""
    torch.manual_seed(0)
    video = VqVideoDiffusionModel(**VIDEO, device="cpu")
    sparse = VqSparseDiffusionModel(**SPARSE, device="cpu")
    tokens = torch.randint(0, 25, (2, 3, 4, 4))
    st = torch.randint(0, 25, (2, 10))
    idx = torch.randperm(48)[:20].reshape(2, 10)
    ctx = dict(grad=torch.enable_grad(), no_grad=torch.no_grad(),
               inference=torch.inference_mode())[mode]
    before = LAUNCHES["dense_tf32"]
    with ctx:
        assert torch.equal(video(tokens), _video_before(video, tokens))
        assert torch.equal(sparse(st, idx), _sparse_before(sparse, st, idx))
    assert LAUNCHES["dense_tf32"] == before


def test_dense_layer_off_the_route_is_dense_apply_then_epilogue():
    x, w, b, r = _operands(6, 16, 24, seed=4)
    assert torch.equal(attention.dense_layer(x, w, b), dense_apply(x, w, b))
    assert torch.equal(attention.dense_layer(x, w, b, gelu=True),
                       F.gelu(dense_apply(x, w, b), approximate="tanh"))
    assert torch.equal(attention.dense_layer(x, w, b, residual=r), dense_apply(x, w, b) + r)


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_dense_layer_applies_dropout_and_takes_the_route_where_it_passes(monkeypatch, p):
    """Off the route the dropout runs between the GELU and the residual, as
    the modules ran it; an active dropout keeps a layer off the route,
    and an inactive one (p = 0 or eval) lets the kernel take it."""
    x, w, b, r = _operands(6, 16, 24, seed=5)
    drop = torch.nn.Dropout(p).train()
    torch.manual_seed(7)
    got = attention.dense_layer(x, w, b, gelu=True, dropout=drop, residual=r)
    torch.manual_seed(7)
    assert torch.equal(got, drop(F.gelu(dense_apply(x, w, b), approximate="tanh")) + r)
    calls = _route_on_cpu(monkeypatch)
    with torch.no_grad():
        attention.dense_layer(x, w, b, dropout=drop, residual=r)
        assert len(calls) == (1 if p == 0.0 else 0)
        attention.dense_layer(x, w, b, dropout=drop.eval(), residual=r)
    assert len(calls) == (2 if p == 0.0 else 1)


def _route_on_cpu(monkeypatch):
    """``tf32_route`` as on a card (every condition but the device), and the
    kernel wrappers (their plain versions on the CPU) counted by layer."""
    calls = []

    def route(x, weight, attached=False):
        return (not attached and not torch.is_grad_enabled()
                and torch.promote_types(x.dtype, weight.dtype) == torch.float32
                and x.shape[-1] == weight.shape[-1] and weight.shape[-1] % 8 == 0
                and x.is_contiguous() and weight.is_contiguous())

    def single(x, w, b=None, **kw):
        calls.append(("single", tuple(w.shape), kw.get("gelu", False),
                      kw.get("residual") is not None))
        return kd.dense_tf32(x, w, b, **kw)

    def group(problems):
        calls.append(("group", tuple(tuple(p[1].shape) for p in problems)))
        return kd.dense_tf32_group(problems)

    monkeypatch.setattr(attention, "tf32_route", route)
    monkeypatch.setattr(attention, "dense_tf32", single)
    monkeypatch.setattr(attention, "dense_tf32_group", group)
    return calls


def test_video_model_on_the_route_layer_by_layer(monkeypatch):
    """Where the route engages, a block is four launches (q | k | v, the
    output projection with the residual, the MLP's up with the GELU and
    down with the residual): 4 depth a forward, close to the unrouted
    forward; the logits over the last frame stay with ``Dense``; with grad
    on the route does not engage."""
    torch.manual_seed(1)
    model = VqVideoDiffusionModel(**VIDEO, device="cpu")
    for clips in (1, 2):  # one clip's last frame is contiguous, two clips' not
        tokens = torch.randint(0, 25, (clips, 3, 4, 4))
        with torch.inference_mode():
            want = model(tokens)
        calls = _route_on_cpu(monkeypatch)
        with torch.inference_mode():
            got = model(tokens)
        inner, dim, mlp = VIDEO["heads"] * VIDEO["dim_head"], VIDEO["dim"], VIDEO["mlp_dim"]
        block = [("group", ((inner, dim),) * 3), ("single", (dim, inner), False, True),
                 ("single", (mlp, dim), True, False), ("single", (dim, mlp), False, True)]
        assert calls == block * VIDEO["depth"]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        monkeypatch.undo()
    calls = _route_on_cpu(monkeypatch)
    model(tokens)
    assert calls == []


def test_sparse_model_on_the_route_layer_by_layer(monkeypatch):
    torch.manual_seed(2)
    model = VqSparseDiffusionModel(**SPARSE, device="cpu")
    st = torch.randint(0, 25, (2, 10))
    idx = torch.randperm(48)[:20].reshape(2, 10)
    with torch.no_grad():
        want = model(st, idx)
    calls = _route_on_cpu(monkeypatch)
    with torch.no_grad():
        got = model(st, idx)
    inner, dim, mlp = SPARSE["heads"] * SPARSE["dim_head"], SPARSE["dim"], SPARSE["mlp_dim"]
    block = [("single", (3 * inner, dim), False, False), ("single", (dim, inner), False, True),
             ("single", (mlp, dim), True, False), ("single", (dim, mlp), False, True)]
    assert calls == block * SPARSE["depth"] + [("single", (SPARSE["num_classes"], dim),
                                                False, False)]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
