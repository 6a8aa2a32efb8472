"""The f32 dense layers' split-TF32 kernel (``csrc/dense_tf32.cu``) on the
card: against its plain version and float64 at the served denoiser's
shapes, a forward captured as a CUDA graph and replayed, the exported
programs against the live f32 module service, and where the kernel runs.

Every test needs a CUDA card and skips without one. This file imports no
JAX; on the card run it without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_port_dense_tf32_card.py --noconftest -m chip -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from world_modelz_tpu_torch import aot
from world_modelz_tpu_torch.kernels import _build
from world_modelz_tpu_torch.kernels import dense_tf32 as kd
from world_modelz_tpu_torch.models import VQAutoEncoder, VqVideoDiffusionModel
from world_modelz_tpu_torch.serve import RolloutService
from world_modelz_tpu_torch.train.dispatch import capture

pytestmark = pytest.mark.chip

# over max(1, |Y|): tests/test_torch_port_dense_split_tf32.py's bound against
# float64; twice it against the plain version, as each lies within it
TOL = 2.0**-19
CLIP_ROWS = 384  # the served m3 clip's 6 x 8 x 8 tokens
# (name, layers (N, K), epilogue) of the served denoiser's launches, and its
# logits' shape (which the model leaves with cuBLAS)
CASES = [("qkv", ((128, 384),) * 3, "none"), ("to_out", ((384, 128),), "residual"),
         ("up", ((512, 384),), "gelu"), ("down", ((384, 512),), "residual"),
         ("logits", ((512, 384),), "none")]
S, IMG, C = 3, 16, 1
TOK = dict(embedding_dim=8, num_embeddings=16, downscale_steps=2, hidden_planes=8,
           in_channels=C)
MODEL = dict(data_shape=(S, 4, 4), dim=64, num_classes=16, extents=(1, 1, 1), depth=2,
             dim_head=32, mlp_dim=96, heads=1)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_kernel_against_plain_and_f64(dev, case, b):
    name, layers, epi = case
    gen = torch.Generator(device=dev).manual_seed(b)
    k = layers[0][1]
    m = b * (64 if name == "logits" else CLIP_ROWS)
    x = torch.randn((m, k), generator=gen, device=dev)
    problems = [(x, torch.randn((n, k), generator=gen, device=dev) * k**-0.5,
                 torch.randn((n,), generator=gen, device=dev) * 0.1) for n, _ in layers]
    res = torch.randn((m, layers[0][0]), generator=gen, device=dev) if epi == "residual" else None
    gelu = epi == "gelu"
    if len(problems) > 1:
        got = kd.dense_tf32_group(problems)
    else:
        got = [kd.dense_tf32(*problems[0], gelu=gelu, residual=res)]
    torch.cuda.synchronize()
    for y, (xx, w, bias) in zip(got, problems):
        plain = kd.dense_tf32_reference(xx, w, bias, gelu=gelu, residual=res)
        ref = xx.double() @ w.double().T + bias.double()
        ref = F.gelu(ref, approximate="tanh") if gelu else ref
        ref = ref + res.double() if res is not None else ref
        scale = ref.abs().clamp(min=1.0)
        assert float(((y.double() - ref).abs() / scale).max()) <= TOL
        assert float(((y.double() - plain.double()).abs() / scale).max()) <= 2 * TOL


def _model(dev, dtype=None):
    torch.manual_seed(0)
    return VqVideoDiffusionModel(**MODEL, device=dev, dtype=dtype)


def test_captured_forward_replays_bitwise(dev):
    model = _model(dev)
    tokens = torch.randint(0, MODEL["num_classes"] + 1, (2, *MODEL["data_shape"]), device=dev)
    with torch.inference_mode():
        eager = model(tokens)
        cap = capture(lambda: model(tokens), dev)
        cap.graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(cap.outputs, eager)
    depth = MODEL["depth"]
    assert cap.wrappers["dense_tf32"] == 4 * depth  # the logits stay with cuBLAS
    assert cap.kernels["dense_tf32_kernel"] == 4 * depth


def test_programs_equal_live_f32_service_and_launch_the_kernel(dev, tmp_path):
    """Both services run the f32 denoiser through the kernel: one seed gives
    the same clips; a serving batch launches it and a bf16 training step
    with autograd does not."""
    torch.manual_seed(1)
    tok = VQAutoEncoder(**TOK, device=dev)
    model = _model(dev)
    aot.export_service(str(tmp_path), tok, model, num_frames=2, num_iterations=3,
                       sample_topk=-1, batch_size=2, seed_frames=S, image_size=IMG,
                       channels=C)
    progs = aot.AOTPrograms.load(str(tmp_path), dev)
    clips = np.random.default_rng(0).uniform(size=(2, S, IMG, IMG, C)).astype(np.float32)
    with RolloutService(tok, model, num_frames=2, num_iterations=3, batch_size=2,
                        device=dev, seed=4) as live:
        before = _build.LAUNCHES["dense_tf32"]
        want = [live.submit(c).result(timeout=300) for c in clips]
        assert _build.LAUNCHES["dense_tf32"] > before
    progs.launches.clear()
    with RolloutService(programs=progs, seed=4) as svc:
        got = [svc.submit(c).result(timeout=300) for c in clips]
    assert progs.launches["dense_tf32"] > 0
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a, c)
    train = _model(dev, torch.bfloat16).train()
    before = _build.LAUNCHES["dense_tf32"]
    tokens = torch.randint(0, MODEL["num_classes"] + 1, (2, *MODEL["data_shape"]), device=dev)
    train(tokens).float().square().mean().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dense_tf32"] == before
