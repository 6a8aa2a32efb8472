"""The port's span recorder (``world_modelz_tpu_torch.utils.tracing``) and
the spans of its shared functions: ``run_dispatch``, ``PrefetchIterator``
and ``RolloutService`` over ``AOTPrograms``, on the CPU at tiny sizes."""

import threading
import time
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu_torch import aot  # noqa: E402
from world_modelz_tpu_torch.data import PrefetchIterator  # noqa: E402
from world_modelz_tpu_torch.models import VQAutoEncoder, VqVideoDiffusionModel  # noqa: E402
from world_modelz_tpu_torch.serve import RolloutService  # noqa: E402
from world_modelz_tpu_torch.train.dispatch import (  # noqa: E402
    StepProgram,
    run_dispatch,
    step_inputs,
)
from world_modelz_tpu_torch.train.timing import TrainTiming  # noqa: E402
from world_modelz_tpu_torch.utils import tracing  # noqa: E402

S, IMG, C, K = 3, 16, 1, 16
TH = IMG // 4


@pytest.fixture
def rec():
    """A clean recorder, on; off and clean again after."""
    tracing.clear()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.clear()


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_spans_nest_by_thread_with_parents_requests_and_counters(rec):
    def worker():
        with tracing.span("w.outer") as outer:
            with tracing.span("w.inner"):
                pass
            tracing.record("w.read", outer.t0, outer.t0 + 5)

    with tracing.span("a", k=1) as a:
        with tracing.span("b") as b:
            t = threading.Thread(target=worker, name="tracing-worker")
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        b.end(b.t0 + 7)
    tracing.record_request("q", 42, a.t0, a.t1 or a.t0 + 3)
    tracing.count("c")
    tracing.count("c", 4)
    got = tracing.collect()
    names = {s.name: s for s in got.spans}
    assert set(names) == {"a", "b", "w.outer", "w.inner", "w.read", "q"}
    assert names["a"].parent is None and names["b"].parent == names["a"].id
    assert names["a"].attrs == {"k": 1} and names["b"].t1 - names["b"].t0 == 7
    # the worker's spans nest on its own thread, not under the main one's
    assert names["w.outer"].parent is None
    assert names["w.inner"].parent == names["w.read"].parent == names["w.outer"].id
    assert names["w.outer"].thread != names["a"].thread
    assert got.threads[names["w.outer"].thread] == "tracing-worker"
    assert names["q"].rid == 42 and names["q"].thread is None and names["a"].rid is None
    assert all(s.t0 <= s.t1 for s in got.spans)
    assert got.counters == {"c": 5} and got.dropped == 0
    assert abs(got.wall_ns(time.perf_counter_ns()) - time.time_ns()) < 50_000_000


def test_buffer_is_bounded_and_counts_what_it_drops(rec, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    tracing.clear()
    for i in range(10):
        with tracing.span(f"s{i}"):
            pass
    got = tracing.collect()
    assert [s.name for s in got.spans] == ["s6", "s7", "s8", "s9"]
    assert got.dropped == 6


def test_off_returns_one_shared_object_reads_no_clock_and_keeps_nothing(monkeypatch):
    tracing.disable()
    tracing.clear()

    def no_clock():
        raise AssertionError("a span site read the clock while off")

    monkeypatch.setattr(tracing, "_clock", no_clock)

    def sites(n):
        for _ in range(n):
            with tracing.span("x", 5) as sp:
                sp.end(9)
            with tracing.span("y"):
                pass
            tracing.record("z", 1, 2)
            tracing.record_request("q", 1, 1, 2)
            tracing.count("c")

    sites(100)
    assert tracing.span("x") is tracing.OFF and not tracing.OFF
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        sites(10_000)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 1024  # nothing kept per call
    monkeypatch.undo()
    got = tracing.collect()
    assert got.spans == [] and got.counters == {}


def test_profiler_session_turns_recording_on():
    tracing.disable()
    tracing.clear()
    with tracing.span("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("inside"):
            torch.ones(2).add_(1)
    assert tracing.span("after") is tracing.OFF
    assert [s.name for s in tracing.collect().spans] == ["inside"]
    # and the profiler's own timeline names it
    assert any(e.name == "inside" for e in prof.events())
    tracing.clear()


def _dispatch_stack(k):
    io = step_inputs({"x": torch.zeros(3)}, None, k)
    program = StepProgram(lambda: io.record(torch.tensor([1.0, 2.0, 1.0])), "cpu",
                          keep=lambda: [])
    return io, program


def test_run_dispatch_spans_are_the_timing_buckets(rec):
    io, program = _dispatch_stack(3)
    tm = TrainTiming(probe_interval=0)
    fed = []
    seen = set()
    for step, n in ((0, 3), (3, 2), (5, 3)):
        rows = run_dispatch(program, io, tm, step, [lambda: fed.append(1)] * n,
                            io.tensors["x"], seen)
        assert rows == [(1.0, 2.0, True)] * n
    spans = tracing.collect().spans
    dispatches = _by_name(spans, "train.dispatch")
    assert len(dispatches) == 3 and len(fed) == 8
    for name, want in (("train.feed", 8), ("train.launch", 8), ("train.stats_read", 3)):
        got = _by_name(spans, name)
        assert len(got) == want, name
        assert {s.parent for s in got} == {d.id for d in dispatches}, name
    reads = _by_name(spans, "train.stats_read")
    total = sum(s.t1 - s.t0 for s in dispatches) * 1e-9
    read = sum(s.t1 - s.t0 for s in reads) * 1e-9
    assert tm.timers["device_wait"] == pytest.approx(read, rel=1e-9, abs=1e-12)
    assert tm.timers["dispatch"] == pytest.approx(total - read, rel=1e-9, abs=1e-12)
    for d, r in zip(dispatches, reads):
        assert d.t1 == r.t1 and d.t0 <= r.t0  # the read ends the dispatch


def test_prefetch_spans_by_thread(rec):
    it = PrefetchIterator(lambda: np.ones((2, 3), np.float32), depth=2, device="cpu")
    try:
        for _ in range(3):
            assert next(it).shape == (2, 3)
    finally:
        it.close()
    spans = tracing.collect().spans
    main = threading.get_native_id()
    waits = _by_name(spans, "data.wait")
    assert len(waits) == 3 and {s.thread for s in waits} == {main}
    produce, h2d = _by_name(spans, "data.produce"), _by_name(spans, "data.h2d")
    assert len(produce) >= 3 and len(h2d) >= 3
    assert {s.thread for s in produce + h2d} == {it._thread.native_id} != {main}


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    torch.manual_seed(0)
    tok = VQAutoEncoder(8, K, 2, 8, C, device="cpu").eval()
    model = VqVideoDiffusionModel((S, TH, TH), dim=16, num_classes=K, extents=(1, 1, 1),
                                  depth=1, dim_head=8, mlp_dim=16, heads=2,
                                  device="cpu").eval()
    path = str(tmp_path_factory.mktemp("artifact"))
    aot.export_service(path, tok, model, num_frames=2, num_iterations=2, batch_size=4,
                       seed_frames=S, image_size=IMG, channels=C)
    return aot.AOTPrograms.load(path, device="cpu")


def test_service_spans_split_each_request_into_queue_and_batch(rec, programs):
    clips = np.random.default_rng(0).uniform(size=(6, S, IMG, IMG, C)).astype(np.float32)
    submitted, done, futs = [], [None] * len(clips), []
    with RolloutService(programs=programs, max_wait_s=0.02) as svc:
        # no batch runs until every callback is in place
        with svc._programs:
            for i, clip in enumerate(clips):
                submitted.append(time.perf_counter_ns())
                fut = svc.submit(clip)
                fut.add_done_callback(
                    lambda f, i=i: done.__setitem__(i, time.perf_counter_ns()))
                futs.append(fut)
        for f in futs:
            assert f.result(timeout=120).shape == (2, IMG, IMG, C)
        stats = dict(svc.stats)
    spans = tracing.collect().spans
    queues = {s.rid: s for s in _by_name(spans, "serve.queue")}
    batches = _by_name(spans, "serve.batch")
    assert len(_by_name(spans, "serve.queue")) == len(clips)
    assert sorted(queues) == list(range(len(clips)))  # ids in enqueue order
    assert len(batches) == stats["batches"] == len(_by_name(spans, "serve.coalesce"))
    rids = sorted(r for b in batches for r in b.attrs["rids"])
    assert rids == list(range(len(clips)))
    batch_of = {r: b for b in batches for r in b.attrs["rids"]}
    for b in batches:
        assert b.attrs["rows"] == len(b.attrs["rids"]) and b.attrs["size"] >= b.attrs["rows"]
    for rid, q in queues.items():
        b = batch_of[rid]
        assert q.t1 <= b.t0
        took = (done[rid] - submitted[rid]) * 1e-9
        assert (q.t1 - q.t0 + b.t1 - b.t0) * 1e-9 == pytest.approx(took, abs=2e-3)
    # the worker's spans: encode and rollout in each batch; frames and
    # finish in each rollout
    ids = {b.id for b in batches}
    for name in ("serve.encode", "serve.rollout"):
        assert {s.parent for s in _by_name(spans, name)} == ids, name
    rollouts = {s.id for s in _by_name(spans, "serve.rollout")}
    frames = _by_name(spans, "serve.frame")
    assert len(frames) == 2 * len(rollouts) and {s.parent for s in frames} == rollouts
    assert {s.parent for s in _by_name(spans, "serve.finish")} == rollouts


def test_chrome_trace_holds_the_spans_one_track_a_thread(tmp_path):
    import json

    from world_modelz_tpu_torch.utils import profiling

    tracing.disable()
    tracing.clear()

    def worker():
        with tracing.span("w.work"):
            time.sleep(0.002)

    with profiling.trace(str(tmp_path)):
        with tracing.span("main.work", k=1):
            torch.ones(8).add_(1)
        t = threading.Thread(target=worker, name="tracing-worker")
        t.start()
        t.join(timeout=30)
        tracing.record_request("req.wait", 3, time.perf_counter_ns() - 10**6,
                               time.perf_counter_ns())
    tracing.clear()
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    mine = [e for e in doc["traceEvents"] if e.get("pid") == profiling.SPANS_PID]
    spans = {e["name"]: e for e in mine if e["ph"] == "X"}
    assert set(spans) == {"main.work", "w.work"}
    assert spans["main.work"]["tid"] != spans["w.work"]["tid"]
    assert spans["main.work"]["args"]["k"] == 1 and spans["w.work"]["dur"] >= 2000
    names = {e["tid"]: e["args"]["name"] for e in mine if e.get("name") == "thread_name"}
    assert names[spans["w.work"]["tid"]] == "tracing-worker" and names[0] == "requests"
    assert [e["ph"] for e in mine if e.get("cat") == "request"] == ["b", "e"]
    # placed by the marks: the profiler's own copy of the span starts with it
    theirs = [e for e in doc["traceEvents"] if e.get("name") == "main.work"
              and e.get("pid") != profiling.SPANS_PID]
    assert len(theirs) == 1
    assert abs(theirs[0]["ts"] - spans["main.work"]["ts"]) < 5000  # us
    assert abs(doc["world_modelz_tpu_torch"]["mark_drift_us"]) < 5000
