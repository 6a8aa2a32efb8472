"""Programs of static buffers, captured as CUDA graphs on the card.

The recipe that both the serving artifact's programs (``aot.py``) and the
trainers' step (``cli/video_diffusion.py``, ``cli/sparse_diffusion.py``)
use: a program is a function that reads and writes only buffers that
outlive it; ``capture`` warms it up on a side stream (so the kernels'
first-use attribute and occupancy calls, cuBLAS's handles and the
allocator's pools are set up outside the graph), puts back the tensors the
warm-up changed, and captures one call into a ``torch.cuda.CUDAGraph``.

A replay passes no kernel wrapper, so ``_build.LAUNCHES`` and the launch
log see only the capture, which launches nothing: ``capture`` takes its
wrapper counts back out of ``_build.LAUNCHES`` and keeps them, with the
kernel names the launch log noted, on the result. Whoever replays adds
them once a replay (``StepProgram.launches``, ``AOTPrograms.launches``).

``StepProgram`` is one train step over static inputs (``StepInputs``):
eager on the CPU, captured at its first call on the card and replayed
after, so a trainer runs the same function at every
``--steps_per_dispatch``. The rest is the two diffusion trainers' shared
loop: ``dispatch_len`` (the JAX trainers' rule for how many steps a
dispatch takes), ``run_dispatch`` (feed and run them, then one host read of
their stats), ``record_steps`` (history and guard, a row a step),
``log_point`` and ``write_timing`` (``--timing_report``).
"""

from __future__ import annotations

import collections
import dataclasses
import re
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from world_modelz_tpu_torch.train.timing import TrainTiming, fence_value
from world_modelz_tpu_torch.utils import tracing

Row = Tuple[float, float, bool]  # a step's (loss, grad norm, ok)


def kernel_name(line: str) -> str:
    """A launch log line (``void (anonymous namespace)::name<args>(
    params)``) -> ``name<args>``."""
    return re.search(r"(\w+(?:<[^()]*>)?)\(", line).group(1)


@dataclasses.dataclass
class Captured:
    """A captured program: the graph, what the captured call returned, and
    the launches it holds by wrapper and (None past the launch log's 64
    names) by kernel name."""

    graph: Any
    outputs: Any
    wrappers: "collections.Counter[str]"
    kernels: Optional["collections.Counter[str]"]


def capture(fn: Callable[[], Any], device: torch.device, *, warmups: int = 2,
            keep: Sequence[torch.Tensor] = ()) -> Captured:
    """Warm ``fn`` up ``warmups`` times on a side stream, restore the tensors
    of ``keep`` to their values before the warm-up, then capture one call of
    ``fn`` into a CUDA graph on ``device``. A failure raises: nothing falls
    back to running ``fn`` uncaptured."""
    from world_modelz_tpu_torch.kernels import _build

    with torch.no_grad():
        saved = [t.clone() for t in keep]
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(warmups):
            fn()
    current.wait_stream(side)
    with torch.no_grad():
        for t, s in zip(keep, saved):
            t.copy_(s)
    del saved
    # the graph allocates from a pool of its own, which cannot take the
    # blocks the warm-up left cached: give them back first
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    before = collections.Counter(_build.LAUNCHES)
    outputs = []

    def run():
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs.append(fn())

    lines = _build.kernels_launched(run)
    wrappers = collections.Counter(_build.LAUNCHES) - before
    for key, n in wrappers.items():  # the capture launched nothing
        _build.LAUNCHES[key] -= n
        if not _build.LAUNCHES[key]:
            del _build.LAUNCHES[key]
    kernels = (collections.Counter(kernel_name(line) for line in lines)
               if len(lines) < _build.LOGGED else None)
    return Captured(graph, outputs[0], wrappers, kernels)


class StepProgram:
    """``fn`` (one step over static buffers, returning nothing) as a program:
    each call runs it eagerly on the CPU; on the card the first call
    captures it (``capture``, the tensors of ``keep()`` put back after the
    warm-up, which must be every tensor the step updates) and every call
    replays the graph.

    Attributes:
      inputs: the static inputs the step reads (a ``StepInputs``), if given.
      captured: the ``Captured`` graph (None before the first call on the
        card, and on the CPU).
      capture_seconds: what the warm-up and the capture took.
      replays: the graph's replays so far.
      launches, kernel_launches: ``collections.Counter`` of the kernel
        launches the replays made, by wrapper and by kernel name (each
        replay adds the captured counts).
    """

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 keep: Callable[[], Iterable[torch.Tensor]], inputs: Any = None):
        self.fn, self.device, self.keep = fn, torch.device(device), keep
        self.inputs = inputs
        self.captured: Optional[Captured] = None
        self.capture_seconds = 0.0
        self.replays = 0
        self.launches: "collections.Counter[str]" = collections.Counter()
        self.kernel_launches: "collections.Counter[str]" = collections.Counter()

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
            return
        if self.captured is None:
            t0 = time.perf_counter()
            self.captured = capture(self.fn, self.device, keep=list(self.keep()))
            self.capture_seconds = time.perf_counter() - t0
        self.captured.graph.replay()
        self.replays += 1
        self.launches.update(self.captured.wrappers)
        if self.captured.kernels is not None:
            self.kernel_launches.update(self.captured.kernels)


def dispatch_len(done: int, kdisp: int, max_steps: int, first_log: int,
                 intervals: Iterable[int]) -> int:
    """Steps to run before the next host read: up to ``kdisp``, but never
    crossing the first log point ``first_log``, the next multiple of any
    nonzero interval (log, histogram, checkpoint, evaluation, probe, batch
    refresh) or ``max_steps``, so host work happens at the step multiples
    it does at k = 1 (the JAX trainers' ``dispatch_len``)."""
    stop = max_steps
    if done < first_log:
        stop = min(stop, first_log)
    for iv in intervals:
        if iv:
            stop = min(stop, (done // iv + 1) * iv)
    return max(1, min(kdisp, stop - done))


@dataclasses.dataclass
class StepInputs:
    """A step program's static inputs and outputs: ``tensors`` (the clip or
    token batch, or a trajectory batch's sprites and positions), ``draws``
    (the step's random numbers), and the (k, 3) ``stats`` buffer, whose row
    ``row`` the next step writes its packed (loss, grad norm, ok) into; the
    step advances ``row``, modulo k (a capture's warm-up calls run more
    than k steps from one ``start``)."""

    tensors: Dict[str, torch.Tensor]
    draws: Any
    stats: torch.Tensor
    row: torch.Tensor

    def record(self, packed: torch.Tensor) -> None:
        self.stats.index_copy_(0, self.row, packed[None])
        self.row.add_(1).remainder_(self.stats.shape[0])

    def start(self) -> None:
        self.row.zero_()

    def read(self, n: int) -> List[Row]:
        """The rows of the ``n`` steps since ``start``: one host read."""
        return [as_row(values) for values in self.stats[:n].tolist()]


def as_row(values: Sequence[float]) -> Row:
    """A packed (loss, grad norm, ok) read back -> a ``Row``."""
    loss, gn, ok = values
    return loss, gn, ok > 0.5


def step_inputs(tensors: Dict[str, torch.Tensor], draws: Any, k: int) -> StepInputs:
    dev = next(iter(tensors.values())).device
    return StepInputs(tensors, draws, torch.zeros((max(1, k), 3), device=dev),
                      torch.zeros((1,), dtype=torch.long, device=dev))


def run_dispatch(program: StepProgram, io: StepInputs, tm: TrainTiming, step: int,
                 feeds: Sequence[Callable[[], None]], last_input: Any,
                 seen_sizes: set) -> List[Row]:
    """One dispatch of ``len(feeds)`` steps from ``step``: each step's feed
    (its batch and draws into ``io``), then the program; then one host read
    of their stats. Charged to the timing's ``dispatch`` and ``device_wait``
    buckets, or, when a device probe is due, timed between value fences
    (each tensor of ``last_input``, a tensor or a dict of them, landed; the
    stats read) into ``probe``. Recorded as the span ``train.dispatch``
    with a ``train.feed`` and a ``train.launch`` a step and one
    ``train.stats_read``, whose edges are the buckets' clock reads."""
    n = len(feeds)
    probe = tm.probe_due(step + n) and tm.opened and n in seen_sizes
    t0 = time.perf_counter_ns()
    with tracing.span("train.dispatch", t0) as sp:
        if probe:
            for x in (last_input.values() if isinstance(last_input, dict) else [last_input]):
                fence_value(x)
        td = time.perf_counter_ns()
        io.start()
        for feed in feeds:
            with tracing.span("train.feed"):
                feed()
            with tracing.span("train.launch"):
                program()
        seen_sizes.add(n)
        t1 = time.perf_counter_ns()
        rows = io.read(n)
        now = time.perf_counter_ns()
        tracing.record("train.stats_read", t1, now)
        sp.end(now)
    if probe:
        tm.record_probe(n, (now - td) * 1e-9)
        tm.add("probe", (now - t0) * 1e-9)
    else:
        tm.add("dispatch", (t1 - t0) * 1e-9)
        tm.add("device_wait", (now - t1) * 1e-9)
    return rows


def record_steps(history: List, guard, rows: Sequence[Row], step: int, cfg,
                 state) -> int:
    """Each row of a dispatch from ``step`` into ``history`` as (step, loss,
    grad norm, ok, host clock) and into the guard; advances ``state.step``
    unless the guard restored a checkpoint (which sets it). Returns the
    rejected steps."""
    now = time.perf_counter()
    rejected, restored = 0, False
    for i, (loss, gn, ok) in enumerate(rows):
        s = step + i + 1
        history.append((s, loss, gn, ok, now))
        accepted = ok or not cfg.nan_guard
        if not accepted:
            rejected += 1
            print(f"{s}: step REJECTED (non-finite loss/grads)")
        restored = guard.record(accepted, s) is not None or restored
    if not restored:
        state.step = step + len(rows)
    return rejected


def log_point(logger, tm: TrainTiming, row: Row, step: int, lr: float, cfg,
              t0: float, start_step: int, kdisp: int, seen_sizes: set) -> float:
    """Log the step's (loss, grad norm, lr, steps/s) and move the timing
    window: it opens at the second log point (the capture excluded; with k >
    1 once a full dispatch ran) and closes at each later one (every log
    point follows a stats read, a value fence). Returns the new log clock."""
    loss, gn, _ = row
    dt, t0 = time.time() - t0, time.time()
    tt = time.perf_counter()
    m = {"loss": loss, "grad_norm": gn, "lr": lr,
         "steps_per_sec": cfg.log_interval / max(dt, 1e-9)}
    logger.log(step, **m)
    print(f"{step}: loss {loss:.3e} lr {lr:.3e} grad_norm {gn:.3e}")
    now = time.perf_counter()
    tm.add("log", now - tt)
    if not tm.opened:
        if step > start_step + 1 and (kdisp == 1 or kdisp in seen_sizes):
            tm.open_window(step, now)
    else:
        tm.close_window(step, now)
    return t0


def write_timing(tm: TrainTiming, cfg, batches, extra: Dict, config: Dict
                 ) -> Optional[Dict]:
    """With ``cfg.timing_report``, write the report (the JAX package's
    ``TrainTiming.report`` keys) there and return it."""
    if not cfg.timing_report:
        return None
    report = tm.report(batch_size=cfg.batch_size, extra=extra,
                       h2d_stats=batches.transfer_stats(), config=config)
    tm.write(cfg.timing_report, report)
    return report
