"""The program's own spans on a traced slice's clock, and the device's idle
time charged to them.

The port records its spans (``world_modelz_tpu_torch/utils/tracing.py``)
while a ``torch.profiler`` session is open, as a traced run's ``prime()``
and slice are. ``view(sl)`` reads them after the run and places them on
the slice's trace clock: a span's ``perf_counter_ns`` edges go to
``time.time()``'s clock by the recorder's clock pair, then to the trace's
by the slice's ``offset_s``. That offset comes from the slice's mark, the
first ``record_function`` of its profiler session, which starts late, so
the spans land 0.3-1.1 ms late on the trace (on an H100's host; PERF.md
§3). The result, cached on the slice as ``sl.program``, holds:

- ``spans``: the program's spans that overlap the slice (``Placed``);
- ``gaps``: every idle interval of the device inside the slice (between
  its operations, and from the slice's start to the first and from the
  last to its end) as (start, end, the span charged or None): the
  innermost span open at the gap's middle on a launching thread, one that
  recorded ``train.launch`` or ``serve.batch``;
- ``idle_by_span``: the gaps' seconds summed by the charged span's name
  (``NO_SPAN`` where none was open).

Where the program has no recorder (a parent without it) or recorded
nothing, ``view`` gives None, and the readers return None: they never fall
back to the harness's own ``portbench.*`` spans.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

LAUNCHING = ("train.launch", "serve.batch")
NO_SPAN = "(no program span)"


class Placed(NamedTuple):
    """A program span on the trace's clock (seconds)."""

    name: str
    start: float
    end: float
    thread: Optional[int]
    id: int
    parent: Optional[int]
    rid: Optional[int]
    attrs: Dict[str, Any]


@dataclasses.dataclass
class Program:
    start: float  # the slice on the trace's clock
    end: float
    spans: List[Placed]
    gaps: List[Tuple[float, float, Optional[Placed]]]
    idle_by_span: Dict[str, float]
    by_id: Dict[int, Placed]

    def named(self, name: str) -> List[Placed]:
        return [s for s in self.spans if s.name == name]

    def idle_under(self, name: str) -> float:
        """Idle seconds charged to spans named ``name`` or to their
        descendants."""
        total = 0.0
        for a, b, sp in self.gaps:
            while sp is not None and sp.name != name:
                sp = self.by_id.get(sp.parent)
            if sp is not None:
                total += b - a
        return total

    def median_ms(self, name: str, edge: str) -> Optional[float]:
        """The median duration, in ms, of the spans named ``name`` whose
        ``edge`` ("start" or "end") lies inside the slice; None if none
        does."""
        xs = [s.end - s.start for s in self.named(name)
              if self.start <= getattr(s, edge) <= self.end]
        return statistics.median(xs) * 1e3 if xs else None


def _place(sl, rec) -> List[Placed]:
    shift = sl.offset_s
    out = []
    for sp in rec.spans:
        out.append(Placed(sp.name, rec.wall_ns(sp.t0) * 1e-9 + shift,
                          rec.wall_ns(sp.t1) * 1e-9 + shift, sp.thread, sp.id, sp.parent,
                          sp.rid, sp.attrs))
    return out


def idle(kernels, start: float, end: float) -> List[Tuple[float, float]]:
    """The intervals of [start, end] in which no (name, start, seconds)
    device operation of ``kernels`` ran."""
    gaps, t = [], start
    for _, s, d in sorted(kernels, key=lambda k: k[1]):
        if s + d <= t:
            continue
        if s >= end:
            break
        if s > t:
            gaps.append((t, s))
        t = max(t, s + d)
    if t < end:
        gaps.append((t, end))
    return gaps


def innermost(spans: List[Placed]) -> Tuple[List[float], List[Tuple[float, float, Placed]]]:
    """One thread's spans (nested, as a thread opens them) as a timeline of
    (from, to, the innermost span open) segments, and their starts."""
    segs: List[Tuple[float, float, Placed]] = []
    stack: List[Placed] = []
    t = float("-inf")

    def emit(until: float, sp: Placed):
        nonlocal t
        if until > t:
            segs.append((t, until, sp))
            t = until

    for sp in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= sp.start:
            emit(stack[-1].end, stack[-1])
            stack.pop()
        if stack:
            emit(sp.start, stack[-1])
        t = max(t, sp.start)
        stack.append(sp)
    while stack:
        emit(stack[-1].end, stack[-1])
        stack.pop()
    return [s[0] for s in segs], segs


def charge(gaps: List[Tuple[float, float]], spans: List[Placed]
           ) -> List[Tuple[float, float, Optional[Placed]]]:
    """Each gap with the innermost span open at its middle on a launching
    thread (the latest opened where two threads have one), or None."""
    threads = {s.thread for s in spans if s.name in LAUNCHING and s.thread is not None}
    by_thread = collections.defaultdict(list)
    for s in spans:
        if s.thread in threads:
            by_thread[s.thread].append(s)
    timelines = [innermost(v) for v in by_thread.values()]
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        best = None
        for starts, segs in timelines:
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid < segs[i][1]:
                sp = segs[i][2]
                if best is None or sp.start > best.start:
                    best = sp
        out.append((a, b, best))
    return out


def view(sl) -> Optional[Program]:
    """The program's spans on the slice ``sl`` (a reduced
    ``portbench.trace.Slice``), or None where there are none."""
    if sl is None or not sl.kernels:
        return None
    cached = getattr(sl, "program", None)
    if cached is not None:
        return cached
    try:
        from world_modelz_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    rec = tracing.collect()
    start = sl.first_s + sl.offset_s
    end = start + sl.window_s
    every = _place(sl, rec)
    placed = [s for s in every if s.end >= start and s.start <= end]
    if not placed:
        return None
    gaps = charge(idle(sl.kernels, start, end), placed)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for a, b, sp in gaps:
        by_name[sp.name if sp is not None else NO_SPAN] += b - a
    sl.program = Program(start, end, placed, gaps, dict(by_name), {s.id: s for s in every})
    return sl.program
