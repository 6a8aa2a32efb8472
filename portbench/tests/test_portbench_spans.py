"""The program's spans on a traced slice (``portbench/spans.py``): the rule
that charges each idle gap to a span, and the five readers of them, on
slices built by hand (device operations, gaps and spans at known times),
with None where the spans are missing. On the card: a span around a kernel
and a synchronise contains the kernel after mapping, and two marks 4 s apart
agree."""

import statistics
import sys
import time
import types

import pytest
import torch

from portbench import loader, spans
from world_modelz_tpu_torch.utils import tracing

MS = 1_000_000  # ns
MAIN, WORKER, PREFETCH = 11, 12, 13
READERS = ("data_wait_share.train", "encode_idle_share.train", "queue_wait_ms.serve",
           "batch_run_ms.serve", "coalesce_idle_share.serve")


def _span(name, t0_ms, t1_ms, thread=MAIN, parent=None, rid=None, **attrs):
    sp = tracing.Span(name, int(t0_ms * MS), thread, parent.id if parent else None, rid,
                      attrs)
    sp.t1 = int(t1_ms * MS)
    return sp


def _slice(kernels_ms, start_ms=0.0, window_ms=1000.0):
    """A reduced slice on a clock where the trace's second is the
    recorder's: ``offset_s`` 0 and the recorder's clock pair (0, 0)."""
    return types.SimpleNamespace(
        kernels=[("k", a * 1e-3, (b - a) * 1e-3) for a, b in kernels_ms],
        first_s=start_ms * 1e-3, window_s=window_ms * 1e-3,
        last_s=(start_ms + window_ms) * 1e-3, offset_s=0.0)


@pytest.fixture
def recorded(monkeypatch):
    """``record(spans)`` makes them what the recorder holds."""
    def record(spans_):
        monkeypatch.setattr(tracing, "collect",
                            lambda: tracing.Collected(list(spans_), {}, {}, (0, 0)))
    return record


def _train_spans():
    wait = _span("data.wait", 0, 200)
    disp = _span("train.dispatch", 200, 900)
    kids = [_span("train.feed", 200, 250, parent=disp),
            _span("train.launch", 250, 300, parent=disp),
            _span("train.stats_read", 500, 900, parent=disp)]
    enc = _span("sparse.encode", 910, 990)
    inner = _span("tok.encode", 920, 930, parent=enc)
    produce = _span("data.produce", 0, 1000, thread=PREFETCH)
    return [wait, disp, *kids, enc, inner, produce]


def test_gaps_are_charged_to_the_innermost_span_of_a_launching_thread(recorded):
    recorded(_train_spans())
    # busy 300-500 and 550-850 and 925-928: gaps 0-300, 500-550, 850-925, 928-1000
    sl = _slice([(300, 500), (550, 850), (925, 928)])
    prog = spans.view(sl)
    got = [(round(a * 1e3), round(b * 1e3), sp.name if sp else None) for a, b, sp in prog.gaps]
    assert got == [(0, 300, "data.wait"),           # middle 150
                   (500, 550, "train.stats_read"),
                   (850, 925, "train.stats_read"),  # middle 887.5
                   (928, 1000, "sparse.encode")]    # middle 964, after tok.encode ended
    by = prog.idle_by_span
    assert by == pytest.approx({"data.wait": 0.3, "train.stats_read": 0.125,
                                "sparse.encode": 0.072})
    assert prog.idle_under("train.dispatch") == pytest.approx(0.125)  # its child's
    assert prog.idle_under("sparse.encode") == pytest.approx(0.072)
    # the prefetch thread never launches: its open span takes no gap
    assert "data.produce" not in by
    assert spans.view(sl) is prog  # cached on the slice


def test_a_gap_with_no_program_span_open_is_charged_to_none(recorded):
    recorded([_span("train.launch", 100, 110), _span("data.wait", 120, 130)])
    prog = spans.view(_slice([(0, 50), (60, 200)], window_ms=300))
    assert [sp.name if sp else None for *_, sp in prog.gaps] == [None, None]
    assert set(prog.idle_by_span) == {spans.NO_SPAN}


def test_innermost_timeline():
    outer = _span("a", 0, 100)
    kid = _span("b", 10, 20, parent=outer)
    kid2 = _span("c", 30, 100, parent=outer)  # ends with its parent
    later = _span("d", 150, 160)
    placed = spans._place(types.SimpleNamespace(offset_s=0.0),
                          tracing.Collected([outer, kid, kid2, later], {}, {}, (0, 0)))
    starts, segs = spans.innermost(placed)
    got = [(round(a * 1e3), round(b * 1e3), sp.name) for a, b, sp in segs]
    assert got == [(0, 10, "a"), (10, 20, "b"), (20, 30, "a"), (30, 100, "c"),
                   (150, 160, "d")]
    assert starts == [s[0] for s in segs]


def _read(name, sl):
    return loader.metric_reader(name)({"trace": sl})


def test_training_readers(recorded):
    recorded(_train_spans())
    sl = _slice([(0, 20), (100, 150), (300, 500), (550, 850), (925, 928)])
    # gaps: 20-100 (wait), 150-300 (middle 225: feed), 500-550, 850-925, 928-1000
    assert _read("data_wait_share.train", sl) == pytest.approx(8.0)
    assert _read("encode_idle_share.train", sl) == pytest.approx(7.2)
    for name in ("queue_wait_ms.serve", "batch_run_ms.serve", "coalesce_idle_share.serve"):
        assert _read(name, sl) is None, name


def test_serving_readers(recorded):
    worker = WORKER
    q = [_span("serve.queue", t0, t1, thread=None, rid=i)
         for i, (t0, t1) in enumerate([(-300, 100), (50, 100), (80, 100),
                                       (200, 600), (500, 600), (900, 1100)])]
    co1 = _span("serve.coalesce", 60, 100, thread=worker)
    b1 = _span("serve.batch", 100, 550, thread=worker, rids=[0, 1, 2], rows=3, size=4)
    r1 = _span("serve.rollout", 110, 540, thread=worker, parent=b1)
    co2 = _span("serve.coalesce", 560, 600, thread=worker)
    b2 = _span("serve.batch", 600, 1200, thread=worker, rids=[3, 4], rows=2, size=2)
    b3 = _span("serve.batch", 1250, 1400, thread=worker, rids=[5], rows=1, size=1)
    recorded(q + [co1, b1, r1, co2, b2, b3])
    sl = _slice([(0, 70), (120, 530), (610, 1000)])
    # queue waits closed inside [0, 1000]: 400, 50, 20, 400, 100 -> median 100
    assert _read("queue_wait_ms.serve", sl) == pytest.approx(100.0)
    # batches closed inside: 450 and 600 ms -> median 525
    assert _read("batch_run_ms.serve", sl) == pytest.approx(525.0)
    # gaps: 70-120 (middle 95: coalesce), 530-610 (570: coalesce 2), 1000 on: none
    assert _read("coalesce_idle_share.serve", sl) == pytest.approx(13.0)
    for name in ("data_wait_share.train", "encode_idle_share.train"):
        assert _read(name, sl) is None, name


def test_readers_are_none_without_spans(recorded, monkeypatch):
    sl = _slice([(0, 10), (20, 30)])
    recorded([])
    for name in READERS:
        assert _read(name, sl) is None, name
    assert all(_read(name, None) is None for name in READERS)
    # spans only outside the slice
    recorded([_span("data.wait", 2000, 2100), _span("train.launch", 2100, 2200)])
    assert all(_read(name, _slice([(0, 10)])) is None for name in READERS)
    # a program without the recorder (the parent of this benchmark's spans)
    monkeypatch.delattr(sys.modules["world_modelz_tpu_torch.utils"], "tracing")
    monkeypatch.setitem(sys.modules, "world_modelz_tpu_torch.utils.tracing", None)
    assert all(_read(name, _slice([(0, 10)])) is None for name in READERS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _busy_wait(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


@pytest.mark.chip
def test_span_contains_its_kernel_on_the_card(card):
    """A span around a kernel launch and a synchronise contains the kernel
    after mapping; the 2 ms either side bound the mapping's error (spans
    land 0.3-1.1 ms late: the slice's mark starts late)."""
    from portbench.trace import Slice, prime

    prime()
    x = torch.randn(4096, 4096, device="cuda")
    x @ x
    torch.cuda.synchronize()
    with Slice() as sl:
        for _ in range(3):
            _busy_wait(5e-3)
            with tracing.span("test.kernel"):
                _busy_wait(2e-3)
                x @ x
                torch.cuda.synchronize()
                _busy_wait(2e-3)
        _busy_wait(5e-3)
    sl.reduce()
    sp = spans.view(sl).named("test.kernel")
    assert len(sp) == 3 and len(sl.kernels) >= 3
    for name, start, seconds in sl.kernels:
        assert any(s.start <= start and start + seconds <= s.end for s in sp), (name, start)


@pytest.mark.chip
def test_marks_four_seconds_apart_agree_on_the_card(card):
    """The profiler's clock against ``perf_counter``: the median offset of
    five marks at the start and five 4 s later agree within 50 us (one
    mark alone jitters by up to ~0.1 ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    reads = []
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(11):  # the first record_function of a session starts late
            if i == 6:
                _busy_wait(4.0)
            reads.append(time.perf_counter_ns())
            with torch.profiler.record_function(f"test.mark{i}"):
                pass
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("test.mark")}
    offsets = [starts[f"test.mark{i}"] - reads[i] for i in range(11)]
    drift = statistics.median(offsets[6:]) - statistics.median(offsets[1:6])
    assert abs(drift) < 50_000, (drift, offsets)
