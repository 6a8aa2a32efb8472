"""Batched continuous rollout service (the serving path).

Port of ``world_modelz_tpu.serve`` (the HTTP front end is
``serve_http.py``):

- Two programs: a seed-clip ENCODER (pixels -> token context) and a
  ROLLOUT (iterative unmask over the token grid for ``num_frames`` frames ->
  decode to pixels + the updated token context).
- Requests enqueue from any thread; a worker coalesces up to ``batch_size``
  of them (waiting at most ``max_wait_s`` after the first) and runs the
  rollout at the smallest size of a power-of-two ladder that fits the batch
  (``stats["padded_rows"]`` counts the rows wasted on padding).
- Streaming sessions (``open_session``): the seed clip is encoded once; each
  ``generate()`` continues from the session's rolled token context.
- Both programs run the tokenizer and the denoiser in eval mode (flax's
  ``train=False``, as the JAX service applies them), whatever mode the
  caller left them in, and give every submodule its own mode back after.
- ``programs=`` (an ``aot.AOTPrograms``) serves an exported artifact
  instead of the modules: on the GPU each program is a replay of CUDA
  graphs. Frames, iterations, top-k and the ladder are the artifact's;
  ``batch_size`` may only cap the ladder. Under one seed both kinds of
  service give the same clips, bit for bit.
- Spans (``utils/tracing.py``): each request gets an id at enqueue and a
  ``serve.queue`` span from its enqueue to the close of the batch that
  holds it; the worker records ``serve.coalesce`` (from the first request
  taken to the close) and ``serve.batch`` (from the close to the last
  future resolved; its ``rids``, ``rows`` and ladder ``size``), and in it
  ``serve.encode`` and ``serve.rollout``.

Example:
    svc = RolloutService(tok, model, num_frames=8)
    futs = [svc.submit(clip) for clip in clips]   # (S, H, W, C) each
    videos = [f.result() for f in futs]           # (T, H, W, C) each
    svc.close()

    svc = RolloutService(programs=AOTPrograms.load("artifact"))
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from world_modelz_tpu_torch._device import DeviceLike, resolve_device
from world_modelz_tpu_torch.diffusion.masked import rollout_frames
from world_modelz_tpu_torch.models.tokenizer import VQAutoEncoder
from world_modelz_tpu_torch.models.video import VqVideoDiffusionModel
from world_modelz_tpu_torch.utils import tracing


class _Entry(NamedTuple):
    """A queued request: its item, future and deadline, its id and its
    enqueue's ``perf_counter_ns``."""

    item: Any
    fut: Future
    deadline: Optional[float]
    rid: int
    enqueued: int


def rolled_context(tokens: torch.Tensor, gen: torch.Tensor) -> torch.Tensor:
    """Context for the NEXT rollout call after generating ``gen``.

    ``rollout_frames`` shifts its context one frame per generated frame and
    keeps the last (generation-slot) frame in place (main2.py:128-129);
    this reproduces its final context from tokens (B, S, th, tw) and gen
    (B, T, th, tw), so sessions continue without re-encoding.
    """
    s = tokens.shape[1]
    if s == 1:
        return tokens  # the context is just the generation slot
    full = torch.cat([tokens[:, :-1], gen.to(tokens.dtype)], dim=1)
    return torch.cat([full[:, -(s - 1):], tokens[:, -1:]], dim=1)


def ladder(batch_size: int) -> List[int]:
    """The rollout sizes: the powers of two below ``batch_size``, and
    ``batch_size``."""
    sizes, s = [], 1
    while s < batch_size:
        sizes.append(s)
        s *= 2
    sizes.append(batch_size)
    return sorted(set(sizes))


@contextlib.contextmanager
def eval_mode(*modules: torch.nn.Module):
    """Run the block with ``modules`` in eval mode (dropout off, BatchNorm
    on its running statistics), then give each submodule its own mode
    back."""
    saved = [(m, m.training) for module in modules for m in module.modules()]
    for module in modules:
        module.eval()
    try:
        yield
    finally:
        for m, training in saved:
            m.training = training


class RolloutSession:
    """A streaming rollout whose token context lives with the service.

    One generate() may be in flight at a time (the context of call N+1 is
    the output of call N).
    """

    def __init__(self, svc: "RolloutService", context_tokens: np.ndarray):
        self._svc = svc
        self._ctx = context_tokens  # (S, th, tw) int
        self._inflight: Optional[Future] = None
        self._lock = threading.Lock()

    def generate_async(self) -> Future:
        """Enqueue the next segment; resolves to (T, H, W, C) pixels."""
        with self._lock:
            if self._inflight is not None and not self._inflight.done():
                raise RuntimeError("session already has a generate() in flight")
            fut = self._svc._submit_tokens(self._ctx, self)
            self._inflight = fut
            return fut

    def generate(self) -> np.ndarray:
        return self.generate_async().result()

    def _update(self, new_ctx: np.ndarray) -> None:
        self._ctx = new_ctx


class RolloutService:
    """Request-coalescing batched video rollout.

    Args:
      tok: frozen ``VQAutoEncoder`` (the tokenizer); not with ``programs``.
      model: the denoiser, ``VqVideoDiffusionModel``; not with
        ``programs``.
      num_frames: generated frames per request (the artifact's with
        ``programs``).
      num_iterations: unmask iterations per frame (main2.py:81 uses 30).
      sample_topk: top-k logit truncation (-1 = off).
      batch_size: max coalesced batch (default 8); rollouts run at the
        powers of two up to it. With ``programs`` it caps the artifact's
        ladder (default: its largest size), and raises below every size.
      max_wait_s: max time the worker waits to fill a batch after the
        first request arrives.
      adaptive_wait: skip the coalescing wait when the EWMA request arrival
        rate cannot fill the batch within max_wait_s anyway.
      seed: seed of the sampler's ``torch.Generator``.
      device: ``None`` means ``"cuda"`` (raises without a GPU); ``tok`` and
        ``model`` must already live there. With ``programs``, their device.
      programs: an ``aot.AOTPrograms`` to serve in place of the modules.
    """

    def __init__(
        self,
        tok: Optional[VQAutoEncoder] = None,
        model: Optional[VqVideoDiffusionModel] = None,
        *,
        num_frames: Optional[int] = None,
        num_iterations: int = 30,
        sample_topk: int = -1,
        batch_size: Optional[int] = None,
        max_wait_s: float = 0.05,
        adaptive_wait: bool = False,
        seed: int = 0,
        device: DeviceLike = None,
        programs=None,
    ):
        if programs is not None:
            dev = programs.device
            if device is not None and torch.device(device) != dev:
                raise ValueError(f"the programs run on {dev}, not {device}")
            # frames, iterations and the ladder are the artifact's; the
            # caller may only cap the batch size
            num_frames = programs.meta["num_frames"]
            cap = max(programs.sizes) if batch_size is None else int(batch_size)
            sizes = sorted(s for s in programs.sizes if s <= cap)
            if not sizes:
                raise ValueError(
                    f"batch_size {batch_size} below every exported size "
                    f"{programs.sizes}")
            batch_size = sizes[-1]
        else:
            if num_frames is None:
                raise TypeError("num_frames is required without `programs`")
            dev = resolve_device(device)
            for name, module in (("tok", tok), ("model", model)):
                if module.device.type != dev.type:
                    raise ValueError(
                        f"{name} lives on {module.device}, the service on {dev}"
                    )
            batch_size = 8 if batch_size is None else int(batch_size)
            sizes = ladder(batch_size)
        self._device = dev
        self._tok = tok
        self._model = model
        self._aot = programs
        self.num_frames = int(num_frames)
        self._num_iterations = int(num_iterations)
        self._sample_topk = int(sample_topk)
        self._batch_size = int(batch_size)
        self._max_wait_s = float(max_wait_s)
        self._adaptive_wait = bool(adaptive_wait)
        self._queue: "queue.Queue" = queue.Queue()
        self._ids = itertools.count()
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(seed)
        self._closed = False
        self.stats = {
            "requests": 0,
            "batches": 0,
            "batched_rows": 0,  # rows actually run (ladder-size total)
            "padded_rows": 0,  # rows wasted on padding
            "encoded_clips": 0,  # pixel seed clips pushed through encode
            "encode_calls": 0,  # encode program runs
            "session_rows": 0,  # rows served from cached token contexts
            "expired": 0,  # requests shed at their queue deadline
            "wait_skipped": 0,  # batches run early (arrival-rate adaptive)
        }
        self._ewma_gap: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._sizes = sizes
        self._lifecycle = threading.Lock()  # orders submit() vs close()
        # one program at a time: open_session encodes on the caller's
        # thread, the worker runs the rest; each switches the modes, or
        # replays graphs over static buffers whose outputs are copied off
        # before the lock is let go
        self._programs = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ programs

    @torch.inference_mode()
    def _encode_call(self, seeds: np.ndarray) -> np.ndarray:
        """(b, S, H, W, C) pixels -> (b, S, th, tw) tokens."""
        if self._aot is not None:
            with self._programs, tracing.span("serve.encode"):
                tokens = self._aot.encode(seeds)
            self.stats["encode_calls"] += 1
            return tokens
        x = torch.as_tensor(seeds, dtype=torch.float32, device=self._device)
        b, s = x.shape[:2]
        with self._programs, tracing.span("serve.encode"), eval_mode(self._tok):
            tokens = self._tok.encode(x.reshape(b * s, *x.shape[2:]))
        self.stats["encode_calls"] += 1
        return tokens.reshape(b, s, *tokens.shape[1:]).cpu().numpy()

    @torch.inference_mode()
    def _rollout_call(self, ctx: np.ndarray):
        """(b, S, th, tw) tokens -> ((b, T, H, W, C) pixels, rolled context)."""
        if self._aot is not None:
            with self._programs, tracing.span("serve.rollout"):
                return self._aot.rollout(ctx, generator=self._generator)
        tokens = torch.as_tensor(ctx, device=self._device).long()
        k = self._tok.num_embeddings
        with self._programs, tracing.span("serve.rollout"), eval_mode(self._tok, self._model):
            gen = rollout_frames(
                self._model, tokens,
                num_frames=self.num_frames, num_classes=k, mask_token=k,
                num_iterations=self._num_iterations,
                sample_topk=self._sample_topk, generator=self._generator,
            )  # (b, T, th, tw)
            b, t = gen.shape[:2]
            decoded = self._tok.decode(gen.reshape(b * t, *gen.shape[2:]))
        decoded = decoded.reshape(b, t, *decoded.shape[1:])
        new_ctx = rolled_context(tokens, gen)
        return decoded.float().cpu().numpy(), new_ctx.cpu().numpy()

    # ----------------------------------------------------------------- API

    def submit(
        self, seed_clip: np.ndarray, timeout_s: Optional[float] = None
    ) -> Future:
        """Enqueue one (S, H, W, C) seed clip; resolves to (T, H, W, C).

        With ``timeout_s``, a request still queued when its deadline passes
        resolves to a ``TimeoutError`` instead of occupying a batch row
        (``stats["expired"]`` counts shed requests).
        """
        return self._enqueue(("pixels", np.asarray(seed_clip), None), timeout_s)

    def open_session(self, seed_clip: np.ndarray) -> RolloutSession:
        """Encode the seed clip once; stream segments via the session."""
        ctx = self._encode_call(np.asarray(seed_clip)[None])[0]
        self.stats["encoded_clips"] += 1
        return RolloutSession(self, ctx)

    def close(self):
        """Drain and stop the worker; pending requests still complete."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- internals

    def _submit_tokens(self, ctx: np.ndarray, session: RolloutSession) -> Future:
        return self._enqueue(("tokens", np.asarray(ctx), session))

    def _enqueue(self, item, timeout_s: Optional[float] = None) -> Future:
        fut: Future = Future()
        deadline = _now() + timeout_s if timeout_s is not None else None
        # closed-check + enqueue are atomic w.r.t. close(): no request can
        # land behind the shutdown signal and starve its future
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("service is closed")
            enqueued = time.perf_counter_ns()
            now = enqueued * 1e-9
            if self._last_arrival is not None:
                gap = now - self._last_arrival
                self._ewma_gap = (
                    gap
                    if self._ewma_gap is None
                    else 0.7 * self._ewma_gap + 0.3 * gap
                )
            self._last_arrival = now
            self._queue.put(_Entry(item, fut, deadline, next(self._ids), enqueued))
        return fut

    def _expired(self, entry) -> bool:
        """Resolve a past-deadline queued request; True if it was shed.
        (A request in a running batch always completes: the deadline bounds
        QUEUE time.)"""
        fut, deadline = entry.fut, entry.deadline
        if deadline is None or _now() < deadline:
            return False
        if not fut.cancelled():
            fut.set_exception(
                TimeoutError("request expired before a batch slot opened")
            )
        self.stats["expired"] += 1
        return True

    def _take_batch(self):
        """Block for the first live request, then coalesce up to
        batch_size, shedding requests whose queue deadline has passed.
        Returns (the batch, the ``perf_counter_ns`` of its close while
        recording, else None), or (None, None) at shutdown."""
        while True:
            first = self._queue.get()
            if first is None:
                return None, None
            if not self._expired(first):
                break
        with tracing.span("serve.coalesce") as sp:
            batch = self._coalesce(first)
        return batch, sp.t1

    def _coalesce(self, first):
        batch = [first]
        # always coalesce what is ALREADY queued, then decide whether
        # waiting for more can pay off
        while len(batch) < self._batch_size:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                break
            if entry is None:
                self._queue.put(None)  # keep the shutdown signal
                return batch
            if not self._expired(entry):
                batch.append(entry)
        gap = self._ewma_gap
        if (
            self._adaptive_wait
            and len(batch) < self._batch_size
            and gap is not None
            and (self._batch_size - len(batch)) * gap > self._max_wait_s
        ):
            # the arrival rate cannot fill the batch inside the wait budget
            self.stats["wait_skipped"] += 1
            return batch
        deadline = _now() + self._max_wait_s
        while len(batch) < self._batch_size:
            timeout = deadline - _now()
            if timeout <= 0:
                break
            try:
                entry = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if entry is None:
                self._queue.put(None)  # keep the shutdown signal
                break
            if not self._expired(entry):
                batch.append(entry)
        return batch

    def _prog_size(self, n: int) -> int:
        for s in self._sizes:
            if s >= n:
                return s
        return self._batch_size

    def _run(self):
        while True:
            batch, closed = self._take_batch()
            if batch is None:
                return
            with tracing.span("serve.batch", closed) as sp:
                if sp:
                    sp.attrs.update(rids=[e.rid for e in batch], rows=len(batch),
                                    size=self._prog_size(len(batch)))
                    for e in batch:
                        tracing.record_request("serve.queue", e.rid, e.enqueued, sp.t0)
                self._serve(batch)

    def _serve(self, batch):
        """Run one batch and resolve its futures."""
        items = [e.item for e in batch]
        futs = [e.fut for e in batch]
        try:
            n = len(items)
            size = self._prog_size(n)

            # pixel requests: encode their seed clips (one padded call)
            pix_idx = [i for i, it in enumerate(items) if it[0] == "pixels"]
            contexts: list = [None] * n
            if pix_idx:
                clips = [items[i][1] for i in pix_idx]
                m = len(clips)
                psize = self._prog_size(m)
                while len(clips) < psize:
                    clips.append(clips[-1])
                enc = self._encode_call(np.stack(clips))
                for j, i in enumerate(pix_idx):
                    contexts[i] = enc[j]
                self.stats["encoded_clips"] += m
            for i, it in enumerate(items):
                if it[0] == "tokens":
                    contexts[i] = it[1]
                    self.stats["session_rows"] += 1

            ctxs = list(contexts)
            while len(ctxs) < size:
                ctxs.append(ctxs[-1])
            out, new_ctx = self._rollout_call(np.stack(ctxs))
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["batched_rows"] += size
            self.stats["padded_rows"] += size - n
            for i, fut in enumerate(futs):
                session = items[i][2]
                if session is not None:
                    session._update(new_ctx[i])
                # a client may have cancel()ed a queued future
                if not fut.cancelled():
                    fut.set_result(out[i])
        except Exception as e:  # propagate to every waiter
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)


def _now() -> float:
    return time.monotonic()
