"""Port parity: the trainers' timing report (``--timing_report``,
``world_modelz_tpu_torch.train.timing``) and the prefetcher's transfer
probes (``data.prefetch.PrefetchIterator(probe_every=...)``) against the
JAX package.

``TrainTiming`` fed the same buckets, windows and probes gives the JAX
report dict exactly (the same keys and the same float arithmetic); the
transfer stats have JAX's keys; both trainers write a report with the JAX
keys when ``timing_report`` is set, with device probes every
``probe_interval`` steps.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu.train import timing as jtiming  # noqa: E402
from world_modelz_tpu_torch import train as ptrain  # noqa: E402
from world_modelz_tpu_torch.cli import sparse_diffusion as sd  # noqa: E402
from world_modelz_tpu_torch.cli import video_diffusion as vd  # noqa: E402
from world_modelz_tpu_torch.data import PrefetchIterator  # noqa: E402
from world_modelz_tpu_torch.models import VQAutoEncoder  # noqa: E402
from world_modelz_tpu_torch.train import timing as ptiming  # noqa: E402

REPORT_KEYS = {"batch_size", "window_steps", "window_secs", "steps_per_sec",
               "samples_per_sec", "breakdown_note", "breakdown_pct", "config"}


def _feed(tm, probes):
    """One scripted run: buckets before, inside and after the window,
    probes inside it."""
    for i, b in enumerate(jtiming.HOST_BUCKETS):
        tm.add(b, 0.01 * (i + 1))
    tm.open_window(10, 100.0)
    for i, b in enumerate(jtiming.HOST_BUCKETS):
        tm.add(b, 0.37 * (i + 2))
    for n, secs in probes:
        tm.record_probe(n, secs)
    tm.close_window(60, 112.5)
    tm.add("data", 5.0)  # after the window: not in the report


@pytest.mark.parametrize("probes", [[], [(10, 0.31), (10, 0.29), (5, 0.2)]],
                         ids=["no_probes", "probes"])
def test_report_equals_jax(probes):
    want_tm, got_tm = jtiming.TrainTiming(probe_interval=10), ptiming.TrainTiming(probe_interval=10)
    for tm in (want_tm, got_tm):
        _feed(tm, probes)
        assert tm.probe_due(20) and not tm.probe_due(25)
    kw = dict(batch_size=8, config={"lr": 0.1}, extra={"token_shape": [6, 8, 8]},
              h2d_stats={"n_probes": 1})
    want, got = want_tm.report(**kw), got_tm.report(**kw)
    assert got == want
    assert REPORT_KEYS <= set(got)
    assert ("probe" in got) == bool(probes) and ("reconciliation" in got) == bool(probes)
    assert ptiming.HOST_BUCKETS == jtiming.HOST_BUCKETS


def test_report_needs_a_closed_window_and_write(tmp_path):
    tm = ptiming.TrainTiming()
    assert tm.report(batch_size=1, config={}) is None
    tm.open_window(1, 0.0)
    assert tm.report(batch_size=1, config={}) is None
    tm.close_window(3, 2.0)
    path = str(tmp_path / "sub" / "t.json")
    rep = tm.report(batch_size=2, config={})
    tm.write(path, rep)
    with open(path) as f:
        assert json.load(f) == rep
    assert rep["steps_per_sec"] == 1.0 and rep["samples_per_sec"] == 2.0
    tm.write("", rep)  # no path: nothing written
    ptiming.fence_value(None)
    ptiming.fence_value(torch.zeros(0))
    ptiming.fence_value(torch.arange(6.0).reshape(2, 3))


def test_transfer_stats_have_the_jax_keys():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from world_modelz_tpu.data.prefetch import PrefetchIterator as JaxPrefetch

    batch = np.zeros((4, 8), np.uint8)
    jit = JaxPrefetch(lambda: batch, depth=2, probe_every=2)
    pit = PrefetchIterator(lambda: batch, depth=2, device=torch.device("cpu"), probe_every=2)
    try:
        for _ in range(5):
            next(jit)
            next(pit)
        want, got = jit.transfer_stats(), pit.transfer_stats()
    finally:
        jit.close()
        pit.close()
    assert set(got) == set(want) and got["note"] == want["note"]
    assert got["n_probes"] >= 2 and got["mb_per_batch"] == want["mb_per_batch"]
    quiet = PrefetchIterator(lambda: batch, device=torch.device("cpu"))
    next(quiet)
    assert quiet.transfer_stats() is None
    quiet.close()


@pytest.fixture(scope="module")
def tok_paths(tmp_path_factory):
    out = {}
    for c in (1, 3):
        cfg = dict(embedding_dim=8, num_embeddings=16, downscale_steps=2,
                   hidden_planes=8, in_channels=c)
        torch.manual_seed(0)
        tok = VQAutoEncoder(**cfg, device="cpu")
        out[c] = ptrain.save_checkpoint(str(tmp_path_factory.mktemp(f"tok{c}")), 0,
                                        {"tokenizer": tok.state_dict()}, cfg)
    return out


@pytest.mark.parametrize("trainer", ["video", "sparse"])
def test_trainers_write_the_timing_report(tok_paths, tmp_path, trainer):
    path = str(tmp_path / "timing.json")
    common = dict(platform="cpu", output_dir=str(tmp_path), batch_size=2, max_steps=12,
                  warmup=2, eval_interval=0, checkpoint_interval=0, log_interval=2,
                  histogram_interval=0, timing_report=path, probe_interval=4,
                  steps_per_dispatch=2, dim=32, depth=1, mlp_dim=24, image_size=16)
    if trainer == "video":
        result = vd.train(vd.VideoDiffusionConfig(
            decoder_model=tok_paths[1], n_past=2, digit_size=6, dim_head=16, heads=2,
            extents=(1, 1, 1), **common))
        extra = {"token_shape": [3, 4, 4]}
        opened = 4  # the first log point after a full dispatch of 2: 2 -> 4
    else:
        result = sd.train(sd.SparseDiffusionConfig(
            decoder_model=tok_paths[3], S=4, H=4, W=4, num_context=24, heads=2,
            buffer_size=60, change_batch_interval=3, **common))
        extra = {"num_context": 24, "num_classes": 16}
        opened = 6  # the batch refresh every 3 steps: the first dispatch of 2 is 4 -> 6
    with open(path) as f:
        rep = json.load(f)
    assert rep == result.timing
    assert REPORT_KEYS | {"probe", "reconciliation"} <= set(rep)
    assert {k: rep[k] for k in extra} == extra
    assert set(rep["breakdown_pct"]) == set(ptiming.HOST_BUCKETS)
    # the window runs from the first log point after step 1 at which a
    # dispatch of the full k has run (JAX's rule) to the last (12)
    assert rep["window_steps"] == 12 - opened and rep["probe"]["n_probes"] >= 1
    assert rep["config"]["probe_interval"] == 4
    assert [h[0] for h in result.history] == list(range(1, 13))
    assert os.path.isfile(path)
