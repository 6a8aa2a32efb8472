"""The plain references against world_modelz_tpu_torch at tiny sizes on the
CPU (f32: they agree to rounding), and each fault a cell can have, planted
in the program under a run, turning ``correct`` false."""

import pytest
import torch

from portbench.runners import training
from portbench.tests import tiny


def test_m3_reference_agrees():
    res = tiny.run_m3()
    gaps = training.compare(res["program"], res["reference"])
    assert res["correct"], res["checks"]
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-5 and gaps["change_gap"] < 1e-3


def test_sparse_reference_agrees():
    res = tiny.run_sparse()
    gaps = training.compare(res["program"], res["reference"])
    assert res["correct"], res["checks"]
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-5 and gaps["change_gap"] < 1e-3


def test_serve_reference_agrees():
    res = tiny.run_serve()
    info = res["info"]
    assert res["correct"], res["checks"]
    assert info["draw_gap"] < 1e-5 and info["enc_gap"] < 1e-6 and info["judged"] > 0
    assert info["unmatched"] == 0 and info["unjudged_share"] == 0.0
    assert res["attempted"] == 10 and res["failed"] == 0


def _unchanged(monkeypatch):
    from world_modelz_tpu_torch.train.optim import ScheduledOptimizer
    monkeypatch.setattr(ScheduledOptimizer, "assign", lambda self, state: None)


def _half_batch(monkeypatch):
    from world_modelz_tpu_torch.cli import sparse_diffusion as sd
    from world_modelz_tpu_torch.cli import video_diffusion as vd
    whole = vd.ce_step

    def half(state, inputs, target, r, cfg):
        h = target.shape[0] // 2
        return whole(state, tuple(x[:h] for x in inputs), target[:h],
                     None if r is None else r[:h], cfg)

    monkeypatch.setattr(vd, "ce_step", half)
    monkeypatch.setattr(sd, "ce_step", half)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["m3", "sparse"])
def test_training_faults_fail(cell, fault, monkeypatch):
    {"unchanged": _unchanged, "half_batch": _half_batch}[fault](monkeypatch)
    res = tiny.run_m3() if cell == "m3" else tiny.run_sparse()
    assert not res["correct"], res["checks"]


def test_serve_altered_token_fails(monkeypatch):
    from world_modelz_tpu_torch import aot
    draw = aot.draw_last_frame

    def altered(logits, gumbel, uniform, alpha, *, mask_token, sample_topk=-1):
        out = draw(logits, gumbel, uniform, alpha, mask_token=mask_token,
                   sample_topk=sample_topk)
        first = out[:, :1, :1]
        out[:, :1, :1] = torch.where(first == mask_token, first, (first + 1) % mask_token)
        return out

    monkeypatch.setattr(aot, "draw_last_frame", altered)
    res = tiny.run_serve()
    assert not res["correct"], res["checks"]


def test_serve_clips_changed_before_encode_fail(monkeypatch):
    """A service that changes the seed clips before it encodes them serves
    answers that no sampled request can be matched to: nothing is judged."""
    import numpy as np
    from world_modelz_tpu_torch.serve import RolloutService
    encode = RolloutService._encode_call
    monkeypatch.setattr(RolloutService, "_encode_call",
                        lambda self, seeds: encode(self, np.asarray(seeds) * np.float32(0.999)))
    res = tiny.run_serve()
    info = res["info"]
    assert not res["correct"], res["checks"]
    assert info["unmatched"] == 4 and info["unjudged_share"] == 1.0 and info["judged"] == 0
