"""Spans and counters of the port's own work, on one host clock.

- ``span(name, t0=None, **attrs)`` is a context manager around a piece of
  work. The recorder keeps its name, its start and end from
  ``time.perf_counter_ns()`` (``t0``, and ``end(t1)`` on the open span,
  take edges the caller read itself, so that a timer which already reads
  the clock shares those reads), the native id of the thread that ran it,
  its parent (the span open on that thread when it opened), a request id
  where one exists (``rid``) and its attributes (``attrs``).
- ``record(name, t0, t1, **attrs)`` keeps a finished span whose edges the
  caller read, on this thread, under the span open here.
- ``record_request(name, rid, t0, t1, **attrs)`` keeps a span that belongs
  to a request and to no thread (a request's wait in a queue opens on the
  submitting thread and closes on the worker).
- ``count(name, n=1)`` adds to a named counter.

Recording is on between ``enable()`` and ``disable()``, and while a
``torch.profiler`` session is open (the flag that ``torch.autograd.
profiler`` keeps for fast checks): a profiled region gets the port's spans
with no call of its own. While the profiler is on, a span also enters
``torch.profiler.record_function`` under its name, so the profiler's host
timeline names the work of the threads it records. Off, ``span()`` checks
those two flags and returns one shared no-op object: it allocates nothing,
reads no clock and calls nothing in torch. No span synchronises the device
or reads a value back.

Records go to an in-memory buffer of ``CAPACITY`` spans; past it the oldest
are dropped and the ``tracing.dropped`` counter counts them. ``collect()``
copies the buffer out, only when asked.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16
DROPPED = "tracing.dropped"

_clock = time.perf_counter_ns
_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_buffer: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_counters: Dict[str, int] = {}
_threads: Dict[int, str] = {}


class Span:
    """One recorded span; ``t1`` is None while it is open."""

    __slots__ = ("name", "t0", "t1", "thread", "id", "parent", "rid", "attrs", "_rf")

    def __init__(self, name: str, t0: Optional[int], thread: Optional[int],
                 parent: Optional[int], rid: Optional[int], attrs: Dict[str, Any]):
        self.name, self.t0, self.t1 = name, t0, None
        self.thread, self.parent, self.rid, self.attrs = thread, parent, rid, attrs
        self.id = next(_ids)
        self._rf = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        if self.t0 is None:
            self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        if self.t1 is None:
            self.t1 = _clock()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _keep(self)
        return False

    def end(self, t1: int) -> None:
        """End the span at ``t1`` (a ``perf_counter_ns`` read of the
        caller's) rather than when its block exits."""
        self.t1 = t1


class _Off:
    """What ``span()`` returns while recording is off: a context manager
    that does nothing, and false."""

    __slots__ = ()
    t1 = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def end(self, t1: int) -> None:
        pass


OFF = _Off()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        current = threading.current_thread()
        _threads[threading.get_native_id()] = current.name
    return stack


def _keep(sp: Span) -> None:
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _counters[DROPPED] = _counters.get(DROPPED, 0) + 1
        _buffer.append(sp)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def span(name: str, t0: Optional[int] = None, **attrs):
    """A span around a block (``with span("data.wait"):``); ``OFF`` while
    recording is off."""
    if not (_on or _profiler._is_profiler_enabled):
        return OFF
    return Span(name, t0, threading.get_native_id(), None, None, attrs)


def record(name: str, t0: int, t1: int, **attrs) -> None:
    """Keep a finished span with edges the caller read, on this thread,
    under the span open here."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    stack = _stack()
    sp = Span(name, t0, threading.get_native_id(), stack[-1].id if stack else None,
              None, attrs)
    sp.t1 = t1
    _keep(sp)


def record_request(name: str, rid: int, t0: int, t1: int, **attrs) -> None:
    """Keep a finished span of request ``rid``, on no thread."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    sp = Span(name, t0, None, None, rid, attrs)
    sp.t1 = t1
    _keep(sp)


def count(name: str, n: int = 1) -> None:
    if not (_on or _profiler._is_profiler_enabled):
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


@dataclasses.dataclass
class Collected:
    """A copy of the recorder: the finished spans in the order they ended,
    the counters, the threads' names by native id, and ``clock``: a
    (``time.time_ns()``, ``perf_counter_ns()``) pair read together, which
    places the spans on wall time."""

    spans: List[Span]
    counters: Dict[str, int]
    threads: Dict[int, str]
    clock: Tuple[int, int]

    @property
    def dropped(self) -> int:
        return self.counters.get(DROPPED, 0)

    def wall_ns(self, t: int) -> int:
        """A ``perf_counter_ns`` reading on ``time.time_ns()``'s clock."""
        return t + self.clock[0] - self.clock[1]


def collect() -> Collected:
    with _lock:
        spans, counters = list(_buffer), dict(_counters)
    wall, perf = time.time_ns(), _clock()
    return Collected(spans, counters, dict(_threads), (wall, perf))


def clear() -> None:
    """Forget every span and counter (a buffer of ``CAPACITY`` anew)."""
    global _buffer
    with _lock:
        _buffer = collections.deque(maxlen=CAPACITY)
        _counters.clear()
