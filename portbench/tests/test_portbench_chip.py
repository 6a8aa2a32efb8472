"""On the card, at each cell's own size, on three seeds: the sound run is
correct; in the training cells the control (the reference in fp8 in the
program's place) and the half-batch fault each fail one of the cell's
numbers; in the serving cell (a short window at the cell's own rate) the
control (the reference's logits in TF32: its first token's gap) fails
``draw_gap``, and a token altered where it is made fails each gap. Skips
without a CUDA card."""

import time

import pytest
import torch

from portbench import loader
from portbench.controls import VARIANTS

SEEDS = (5000000001, 5000000002, 5000000003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["m3.train_b64", "sparse_s32.train_b48"])
def test_controls_fail(card, name, seed):
    cell = loader.workload(name)
    cfg = loader.config(cell["config"])
    res = loader.runner(cell["runner"]).run(cell, cfg, seed=seed, seconds=1.0, trace=False,
                                            t0=time.perf_counter(), variants=VARIANTS)
    limits = cell["limits"]
    assert res["correct"], res["checks"]
    for variant, numbers in res["variants"].items():
        assert any(numbers[n] > float(v) for n, v in limits.items()), (variant, numbers)


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
def test_serve_control_fails(card, seed):
    cell = loader.workload("m3.serve_r80")
    cfg = loader.config(cell["config"])
    res = loader.runner(cell["runner"]).run(cell, cfg, seed=seed, seconds=6.0, trace=False,
                                            t0=time.perf_counter())
    limits, info = cell["limits"], res["info"]
    assert res["correct"], res["checks"]
    assert info["control_gap"] > float(limits["draw_gap"]), info
    for gap in ("enc_gap", "draw_gap", "pixel_gap"):
        assert info["fault_" + gap] > float(limits[gap]), (gap, info)
