"""Port parity: ``world_modelz_tpu_torch.utils.flops`` and
``utils.profiling`` against the JAX package's: every FLOP count the same
integer for the m3 denoiser, the sparse model and the tokenizer; no peak on
the CPU; parameter counts equal to JAX's on converted weights; the trace
and the timing harness run."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from world_modelz_tpu.models.video import VqVideoDiffusionModel as JaxDenoiser  # noqa: E402
from world_modelz_tpu.utils import flops as jflops  # noqa: E402
from world_modelz_tpu.utils import profiling as jprof  # noqa: E402
from world_modelz_tpu_torch import convert  # noqa: E402
from world_modelz_tpu_torch.models import VqVideoDiffusionModel  # noqa: E402
from world_modelz_tpu_torch.utils import flops, profiling  # noqa: E402

# the m3 denoiser at train_step/m3_b64_g8_full, the sparse model at
# train_sparse/s16_n1024_b16, the m3 tokenizer at 64x64x1
COUNTS = {
    "m3": [
        ("local3d_transformer_flops", dict(
            batch=64, data_shape=(6, 8, 8), dim=384, depth=20, heads=1, dim_head=128,
            mlp_dim=512, extents=(3, 1, 1), num_classes=512)),
        ("local3d_transformer_flops", dict(
            batch=8, data_shape=(6, 8, 8), dim=384, depth=20, heads=1, dim_head=384,
            mlp_dim=512, extents=(3, 1, 1), num_classes=512, last_frame_head=False)),
        ("local3d_attention_flops", dict(n_queries=64 * 384, extents=(3, 1, 1),
                                         inner_dim=128)),
    ],
    "sparse": [
        ("dense_transformer_flops", dict(batch=16, n_tokens=1024, dim=512, depth=8,
                                         heads=8, dim_head=64, mlp_dim=1024,
                                         num_classes=512)),
        ("dense_transformer_flops", dict(batch=2, n_tokens=100, dim=64, depth=2, heads=1,
                                         dim_head=64, mlp_dim=128)),
    ],
    "tokenizer": [
        ("vqae_encode_flops", dict(image_hw=(64, 64), in_channels=1, embedding_dim=64,
                                   hidden_planes=128, downscale_steps=3)),
        ("vqae_decode_flops", dict(image_hw=(64, 64), in_channels=3, embedding_dim=64,
                                   hidden_planes=128, downscale_steps=2)),
        ("vq_search_flops", dict(n=24_576, k=512, d=64)),
        ("vq_search_flops", dict(n=3_072, k=512, d=64, one_hot_decode=True)),
    ],
}


@pytest.mark.parametrize("config", sorted(COUNTS))
def test_flop_counts_are_jax_integers(config):
    for name, kw in COUNTS[config]:
        got, want = getattr(flops, name)(**kw), getattr(jflops, name)(**kw)
        assert type(got) is int and got == want, (name, kw)
        for remat in (False, True):
            assert flops.train_step_flops(got, remat) == jflops.train_step_flops(want, remat)


def test_peaks_and_mfu(monkeypatch):
    assert flops.device_peak() is None  # the CPU
    spec = flops.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]
    assert (spec["bf16_flops"], spec["tf32_flops"], spec["f32_flops"], spec["hbm_gbps"]) == (
        989e12, 495e12, 67e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert flops.device_peak() == {"device": "NVIDIA H100 80GB HBM3", **spec}
    for other in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "NVIDIA H100 NVL"):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, name=other: name)
        assert flops.device_peak() is None, other
    for args in ((1e12, 0.5, 989e12), (1e12, 0.0, 989e12), (1e12, 0.5, None)):
        assert flops.mfu(*args) == jflops.mfu(*args)


def test_count_parameters_equals_jax_on_converted_weights():
    shape = (3, 4, 4)
    jmodel = JaxDenoiser(data_shape=shape, dim=16, num_classes=8, extents=(1, 1, 1),
                         depth=2, dim_head=8, mlp_dim=24, heads=2, backend="xla")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, *shape), jnp.int32))[
        "params"]
    model = VqVideoDiffusionModel(data_shape=shape, dim=16, num_classes=8, extents=(1, 1, 1),
                                  depth=2, dim_head=8, mlp_dim=24, heads=2, device="cpu")
    sd = convert.video_state_dict_from_params(jax.device_get(params))
    model.load_state_dict(sd, strict=True)
    want = jprof.count_parameters(params, verbose=False)
    assert profiling.count_parameters(model, verbose=False) == want
    assert profiling.count_parameters(sd, verbose=False) == want
    assert profiling.count_parameters({"a": [np.zeros((2, 3)), torch.zeros(4)]},
                                      verbose=False) == 10


def test_trace_writes_a_chrome_trace_and_benchmark_fn_times(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")):
        y = x @ x
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    seconds, out = profiling.benchmark_fn(lambda a: a @ a, x, iters=3, warmup=1)
    assert seconds > 0 and torch.equal(out, y)
    assert os.path.isdir(tmp_path / "tr")
