"""A profiled slice of a window, reduced to what the readers take.

``Slice`` runs ``torch.profiler`` (CPU and CUDA activities) over a few
seconds that start and end on a synchronised point, then keeps:

- ``kernels``: every device operation (kernels, copies, sets) as
  (name, start_s, seconds) on the device's clock;
- ``busy_s``: the union of their intervals; ``window_s``: the slice's
  length on the host clock;
- ``first_s``, ``last_s``: the slice's ends on ``time.time()``'s clock, and
  ``offset_s``: the trace's clock minus that one, so a caller's wall-clock
  records can be placed among the device operations;
- ``gaps``: the idle intervals between device operations inside the slice,
  each named by the innermost host span open at its middle (the harness's
  own ``portbench.*`` spans, or PyTorch's operators and runtime calls).

``breakdown()`` is the result line's ``breakdown``: the ten device
operations that took most time, summed by name, and the ten longest idle
gaps.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Tuple

import torch


def _ns(ev, what: str) -> float:
    """An event's start or duration in ns, whichever accessor this torch
    has."""
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, f"{what}_us")()) * 1e3


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def prime() -> None:
    """Start and stop the profiler once: its first start in a process loads
    and sets up CUPTI, which takes seconds; a traced run primes it during
    set-up so that the slice's start does not stall the window."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()


class Slice:
    """``with Slice() as s:`` profiles its block; the block must start and
    end with the device idle (after a synchronising read). ``reduce()``
    then reads the events."""

    def __init__(self):
        self.kernels: List[Tuple[str, float, float]] = []
        self.gaps: List[Tuple[str, float]] = []
        self.busy_s = 0.0
        self.window_s = 0.0
        self.units = 0  # steps or requests the caller ran inside the slice

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self.start_cost_s = self._t0 - t
        self.first_s = time.time()
        self._mark = time.time_ns()
        with torch.profiler.record_function("portbench.mark"):
            pass
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.last_s = self.first_s + self.window_s
        t = time.perf_counter()
        self._prof.__exit__(*exc)
        self.stop_cost_s = time.perf_counter() - t
        return False

    def reduce(self) -> "Slice":
        """Read the profiler's events (after the window: it takes a while)."""
        if hasattr(self, "_prof"):
            self._reduce(self._prof.profiler.kineto_results.events())
            del self._prof
        return self

    def _reduce(self, events) -> None:
        dev, host = [], []
        for ev in events:
            start, dur = _ns(ev, "start"), _ns(ev, "duration")
            (dev if _is_device(ev) else host).append((ev.name(), start, dur))
        # the trace's clock against time.time(): the mark span opened at a
        # known wall time
        marks = [s for n, s, _ in host if n == "portbench.mark"]
        self.offset_s = (marks[0] - self._mark) * 1e-9 if marks else 0.0
        # a host span (record_function) also shows on the device's timeline
        # as an annotation: not an operation of the device
        spans = {n for n, _, _ in host}
        dev = [e for e in dev if e[0] not in spans]
        dev.sort(key=lambda e: e[1])
        self.kernels = [(n, s * 1e-9, d * 1e-9) for n, s, d in dev]
        merged: List[List[float]] = []
        for _, s, d in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        self.busy_s = sum(b - a for a, b in merged) * 1e-9
        longest = sorted(((nxt - end, end, nxt) for (_, end), (nxt, _)
                          in zip(merged, merged[1:])), reverse=True)[:10]
        self.gaps = []
        for length, end, nxt in longest:
            mid = 0.5 * (end + nxt)
            open_spans = [(d, n) for n, s, d in host if s <= mid <= s + d]
            name = min(open_spans)[1] if open_spans else "host: no span open"
            self.gaps.append((name, length * 1e-9))

    def kernel_seconds(self, *needles: str, between=None) -> float:
        """Device seconds of the operations whose name holds any needle (any
        operation without needles), with ``between`` only those inside one
        of its (start, end) intervals of ``time.time()``."""
        total = 0.0
        spans = [(a + self.offset_s, b + self.offset_s) for a, b in between or ()]
        for n, s, d in self.kernels:
            if needles and not any(x in n for x in needles):
                continue
            if between is not None and not any(a <= s and s + d <= b for a, b in spans):
                continue
            total += d
        return total

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for n, _, d in self.kernels:
            by_name[n] += d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in self.gaps[:10]]}

