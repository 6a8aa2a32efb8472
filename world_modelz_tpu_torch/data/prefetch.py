"""Host -> device prefetching.

Port of ``world_modelz_tpu.data.prefetch.PrefetchIterator``: a worker
thread assembles host batches into a bounded queue, ``depth`` batches
ahead, and copies each to the device from pinned memory with
``non_blocking=True``, so ``next()`` usually returns a batch that is
already on its way to the card. A batch is an array or a dict of arrays
(a trajectory batch, ``data/device_composite.py``), each leaf copied so.
With ``probe_every`` N > 0, every Nth copy is fenced (one element of each
leaf read back) and timed, for the trainers' timing report
(``transfer_stats``, ``train/timing.py``). With ``state_fn`` (a Grain
pipeline's ``get_state``), the source's position rides the queue with its
batch, so ``consumed_state()`` is the position of the last batch taken,
not of the one prefetched ahead: what a checkpoint must record. Spans
(``utils/tracing.py``): ``data.wait`` (the consumer blocked on the queue),
and on the worker ``data.produce`` (``make_batch``) and ``data.h2d`` (the
copy's enqueue).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from world_modelz_tpu_torch.utils import tracing


def batch_to(batch: Any, device) -> Any:
    """A host batch (a numpy array or tensor, or a dict of them, such as a
    trajectory batch) as tensors on ``device``; host memory is pinned first
    when the target is a GPU."""
    if isinstance(batch, dict):
        return {k: batch_to(v, device) for k, v in batch.items()}
    device = torch.device(device)
    t = torch.as_tensor(np.ascontiguousarray(batch)) if isinstance(
        batch, np.ndarray) else batch
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _leaves(batch: Any) -> list:
    return list(batch.values()) if isinstance(batch, dict) else [batch]


class PrefetchIterator:
    """Wrap a host batch function with background prefetch and device copy.

    Args:
      make_batch: callable returning the next host batch (a numpy array or
        a tensor, or a dict of them).
      depth: number of batches to keep ready ahead of the consumer.
      device: target device; None keeps batches on the host.
      probe_every: if > 0, every Nth device copy is fenced and timed (the
        fence briefly serializes the worker; keep N large).
      state_fn: the source's checkpoint state, called in the worker right
        after each ``make_batch`` (so it never races the source) and once
        before the worker starts (the position before any batch).

    An exception in ``make_batch`` is raised by the ``next()`` that would
    have returned its batch. ``close()`` stops and joins the worker.
    """

    _SENTINEL = object()

    def __init__(
        self,
        make_batch: Callable[[], Any],
        depth: int = 2,
        device: Optional[torch.device] = None,
        probe_every: int = 0,
        state_fn: Optional[Callable[[], Any]] = None,
    ):
        self._make_batch = make_batch
        self._state_fn = state_fn
        self._consumed_state = state_fn() if state_fn is not None else None
        self._device = torch.device(device) if device is not None else None
        self._probe_every = int(probe_every)
        self._n_put = 0
        self._h2d: list = []  # (bytes, seconds) of the fenced copies
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                with tracing.span("data.produce"):
                    batch = self._make_batch()
                state = self._state_fn() if self._state_fn is not None else None
                if self._device is not None:
                    self._n_put += 1
                    probe = self._probe_every > 0 and self._n_put % self._probe_every == 0
                    t0 = time.perf_counter()
                    with tracing.span("data.h2d"):
                        batch = batch_to(batch, self._device)
                    if probe:
                        from world_modelz_tpu_torch.train.timing import fence_value

                        leaves = _leaves(batch)
                        for leaf in leaves:
                            fence_value(leaf)
                        self._h2d.append((sum(x.numel() * x.element_size() for x in leaves),
                                          time.perf_counter() - t0))
            except Exception as e:  # raised again by the consumer's next()
                self._error = e
                self._put(self._SENTINEL)
                return
            self._put((batch, state))

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        with tracing.span("data.wait"):
            item = self._queue.get()
        if item is self._SENTINEL:
            raise self._error if self._error else StopIteration
        batch, state = item
        if state is not None:
            self._consumed_state = state
        return batch

    def consumed_state(self):
        """The source's state as of the last batch taken (the initial
        position before any); None without ``state_fn``."""
        return self._consumed_state

    def transfer_stats(self):
        """Fenced host-to-device copy stats (None if never probed), with the
        JAX package's keys."""
        if not self._h2d:
            return None
        times = sorted(t for _, t in self._h2d)
        med = times[len(times) // 2]
        mb = self._h2d[-1][0] / 1e6
        return {
            "n_probes": len(self._h2d),
            "h2d_ms_per_batch": round(med * 1e3, 3),
            "mb_per_batch": round(mb, 3),
            "mb_per_sec": round(mb / max(med, 1e-9), 1),
            "note": "fenced device_put of one prefetched batch (worker "
            "thread); steady-state puts are async and may overlap compute",
        }

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)
