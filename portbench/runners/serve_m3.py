"""The m3 rollout service from an exported artifact (``world_modelz_tpu_torch.
serve.RolloutService`` over ``aot.AOTPrograms``) on one card, under an open
loop of seed clips.

Set-up: the tokenizer and the denoiser get f32 weights made on the card from
the seed; ``aot.export_service`` writes the artifact (the cell's frames,
iterations, top-k and ladder) under the run's temporary directory;
``AOTPrograms.load`` captures every ladder size's programs; a burst of
requests warms the service. The window offers the traffic's requests at
their due times through ``RolloutService.submit`` from one thread; each
request's latency runs from its due time to its result. After the window
every request due in it is awaited (a minute at most); one that fails or
never comes counts as missing.

The service's calls of the artifact's programs are recorded (the tokens each
encode returned; the tokens, the generator's state, the rolled context and
the pixels of each rollout), so that after the window the reference
(``portbench.reference.serve``) judges a sample of the requests drawn from
the seed.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import traffic as gen_traffic
from portbench.reference import serve as ref_serve
from portbench.runners import training
from portbench.runners.train_m3 import load_tokenizer, weights
from portbench import trace as tracing
from portbench.trace import Slice
from world_modelz_tpu_torch.aot import AOTPrograms, export_service
from world_modelz_tpu_torch.models import VqVideoDiffusionModel
from world_modelz_tpu_torch.serve import RolloutService


def served_rows(tokens: np.ndarray) -> int:
    """The rows of a rollout call that serve requests: the service pads a
    batch to its ladder size with copies of the last request's context."""
    n = tokens.shape[0]
    while n > 1 and np.array_equal(tokens[n - 2], tokens[-1]):
        n -= 1
    return n


class Recorder:
    """Wraps the loaded programs' ``encode`` and ``rollout`` (the calls the
    service makes) to keep what each returned, and each rollout call's wall
    clock interval, ladder size and served rows for the readers."""

    def __init__(self, progs: AOTPrograms):
        self.encodes: List[Dict] = []
        self.rollouts: List[Dict] = []
        self.keep = True
        # held by the traced run while the profiler starts and stops, so
        # that no program call runs on the card meanwhile (a stop during a
        # call's device read hung a run)
        self.gate = threading.Lock()
        self._encode, self._rollout = progs.encode, progs.rollout
        progs.encode, progs.rollout = self.encode, self.rollout

    def encode(self, seeds):
        with self.gate:
            tokens = self._encode(seeds)
        if self.keep:
            self.encodes.append({"seeds": np.asarray(seeds), "tokens": tokens})
        return tokens

    def rollout(self, tokens, generator=None, noise=None):
        tokens = np.asarray(tokens)
        rec = {"t0": time.time(), "b": tokens.shape[0], "n": served_rows(tokens)}
        if self.keep:
            rec.update(tokens=torch.as_tensor(np.array(tokens)),
                       state=generator.get_state() if generator is not None else None)
        with self.gate:
            pixels, ctx = self._rollout(tokens, generator=generator, noise=noise)
        rec["t1"] = time.time()
        if self.keep:
            rec.update(pixels=torch.as_tensor(pixels), context=torch.as_tensor(ctx))
        self.rollouts.append(rec)
        return pixels, ctx


def build_service(cfg: Dict, seed: int, device, max_wait_s: float):
    tok_w, den_w = weights(cfg, seed, device)
    tok = load_tokenizer(cfg, tok_w, device)
    grid = cfg["image_size"] // 2 ** cfg["tokenizer"]["downscale_steps"]
    seq = cfg["n_past"] + 1
    model = VqVideoDiffusionModel(
        data_shape=(seq, grid, grid), dim=cfg["dim"], num_classes=tok.num_embeddings,
        extents=tuple(cfg["extents"]), depth=cfg["depth"], dim_head=cfg["dim_head"],
        mlp_dim=cfg["mlp_dim"], heads=cfg["heads"], device=device)
    model.load_state_dict(den_w, strict=True)
    del tok_w, den_w
    sv = cfg["serve"]
    art = tempfile.mkdtemp(prefix="portbench_artifact_")
    try:
        export_service(art, tok, model.eval(), num_frames=sv["num_frames"],
                       num_iterations=sv["num_iterations"], sample_topk=sv["topk"],
                       batch_size=sv["batch_size"], seed_frames=seq,
                       image_size=cfg["image_size"], channels=tok.in_channels)
        del tok, model
        training.free_cuda()
        progs = AOTPrograms.load(art, device)
    finally:
        shutil.rmtree(art, ignore_errors=True)
    rec = Recorder(progs)
    svc = RolloutService(programs=progs, seed=seed, max_wait_s=max_wait_s)
    return progs, rec, svc


def offer(svc, clips: np.ndarray, due: np.ndarray, seconds: float, trace: bool,
          trace_seconds: float, gate=None):
    """Submit clip i at due[i] seconds from the start (open loop) from a
    thread of its own; with ``trace``, this thread profiles
    ``trace_seconds`` from the window's middle meanwhile, holding ``gate``
    while the profiler starts and stops, and keeps the service's counters
    at the slice's end on the slice (``stats``). Returns (start, futures,
    their finish times, the slice, the latest a submit ran after its due
    time)."""
    n = len(due)
    done, futures, late = [None] * n, [None] * n, [0.0]
    start = time.perf_counter()

    def arrivals():
        for i, at in enumerate(due):
            wait = start + at - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[0] = max(late[0], time.perf_counter() - start - at)
            fut = svc.submit(clips[i])
            fut.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))
            futures[i] = fut

    thread = threading.Thread(target=arrivals, daemon=True)
    thread.start()
    sl = None
    if trace:
        time.sleep(max(0.0, start + 0.5 * (seconds - trace_seconds) - time.perf_counter()))
        with gate:
            sl = Slice().__enter__()
        time.sleep(trace_seconds)
        with gate:
            sl.stats = dict(svc.stats)
            sl.__exit__(None, None, None)
    thread.join()
    return start, futures, done, sl, late[0]


def run(cell: Dict, cfg: Dict, *, seed: int, seconds: float, trace: bool, t0: float,
        device=None) -> Dict:
    device = torch.device(device or "cuda")
    tr = cell["traffic"]
    rate = float(tr["rate"])
    progs, rec, svc = build_service(cfg, seed, device, float(tr.get("max_wait_s", 0.05)))
    n = max(1, int(round(rate * seconds)))
    sv = cfg["serve"]
    seq = cfg["n_past"] + 1
    clips = gen_traffic.clips(seed, n + sv["batch_size"], seq, cfg["image_size"],
                              cfg["tokenizer"]["in_channels"])
    due = gen_traffic.arrivals(n, rate, seed)
    if trace:
        tracing.prime()
    try:
        rec.keep = False  # warm-up: every ladder size once, not judged
        for size in progs.sizes:
            for f in [svc.submit(c) for c in clips[n:n + size]]:
                f.result()
        rec.rollouts.clear()
        rec.keep = True
        stats0 = dict(svc.stats)
        setup_s = time.perf_counter() - t0
        start, futures, done, sl, late = offer(svc, clips[:n], due, seconds, trace,
                                                float(tr.get("trace_seconds", 4.0)), rec.gate)
        failed = 0
        for f in futures:
            try:
                f.result(timeout=max(0.0, start + seconds + 60.0 - time.perf_counter()))
            except Exception:
                failed += 1
        drained = time.perf_counter()
        stats = {k: svc.stats[k] - stats0.get(k, 0) for k in svc.stats}
    finally:
        svc.close()
    latency = [(d - start - at) if d is not None and f.done() and f.exception() is None
               else math.inf for d, at, f in zip(done, due, futures)]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if sl is not None:
        sl.reduce()
        sl.batches = [r for r in rec.rollouts if sl.first_s <= r["t0"] and r["t1"] <= sl.last_s]
        sl.units = sum(r["n"] for r in sl.batches)
    del progs, svc
    training.free_cuda()

    t_judge = time.perf_counter()
    answers = [f.result() if d is not None and f.done() and f.exception() is None else None
               for d, f in zip(done, futures)]
    found = judge(cfg, cell, seed, device, clips[:n], answers, rec)
    judge_s = time.perf_counter() - t_judge
    limits = cell["limits"]
    correct = failed == 0 and all(found[k] <= float(v) for k, v in limits.items())
    q = quantiles(latency)
    # the traced run's counters up to the slice's end: the profiler's stop
    # pauses the service, and the requests due meanwhile then batch fuller
    counted = ({k: sl.stats[k] - stats0.get(k, 0) for k in sl.stats} if sl is not None
               else stats)
    ctx = {"cell": cell, "config": cfg, "trace": sl, "chips": 1, "kind": kind,
           "stats": counted, "batch": sv["batch_size"]}
    return {
        "correct": correct, "attempted": n, "failed": failed,
        "metrics": {"serve_p95_ms": q[0] * 1e3, "serve_p50_ms": q[1] * 1e3, "setup_s": setup_s},
        "device": training.device_record(device, 1, peak, sl),
        "breakdown": sl.breakdown() if sl else None,
        "checks": training.checks(found, limits), "ctx": ctx,
        "info": {"setup_s": setup_s, "rate": rate, "requests": n, "failed": failed,
                 "p50_ms": q[1] * 1e3, "p95_ms": q[0] * 1e3, "max_ms": max(latency) * 1e3,
                 "submit_late_ms": late * 1e3, "stats": stats, **found,
                 "trace_costs_s": [sl.start_cost_s, sl.stop_cost_s] if sl else None,
                 "drained_s": drained - start - seconds, "judge_s": judge_s},
    }


def quantiles(latency: List[float]):
    """(95th percentile, median) of the latencies, a missing one infinite."""
    xs = sorted(latency)
    return (float(np.quantile(xs, 0.95, method="higher")),
            float(np.quantile(xs, 0.5, method="higher")))


def locate(rec: Recorder, clip: np.ndarray, answer):
    """The recorded program calls that served ``clip``: (the encode call,
    its row, the rollout call, its row), found by the clip among the encode
    calls' seeds and by that row's tokens among the rollout calls' inputs,
    and held only where the request's answer is that rollout row's pixels;
    None where any of these is not found."""
    for enc in rec.encodes:
        for row in range(enc["seeds"].shape[0]):
            if not np.array_equal(enc["seeds"][row], clip):
                continue
            tokens = torch.as_tensor(np.asarray(enc["tokens"][row]))
            for call in rec.rollouts:
                for r in range(call["n"]):
                    if torch.equal(call["tokens"][r], tokens):
                        ok = answer is not None and np.array_equal(
                            np.asarray(answer), call["pixels"][r].numpy())
                        return (enc, row, call, r) if ok else None
            return None
    return None


def judge(cfg: Dict, cell: Dict, seed: int, device, clips: np.ndarray, answers: List,
          rec: Recorder) -> Dict:
    """The numbers compared: the sample's encode and rollout gaps,
    ``unmatched`` (sampled requests that ``locate`` does not find, or whose
    answer is not the program's) and ``unjudged_share`` (the share of the
    sample's frames that the reference did not judge, a request not found
    counting with all its frames)."""
    training.reference_precision()
    tok_w, den_w = weights(cfg, seed, device)
    check = cell["check"]
    rng = np.random.default_rng(seed)
    sample = rng.choice(len(clips), size=min(check["requests"], len(clips)), replace=False)
    found = [locate(rec, clips[i], answers[i]) for i in sample]
    enc_gap, fault_enc_gap = 0.0, math.inf
    by_call: Dict[int, Tuple[Dict, List[int]]] = {}
    for hit in found:
        if hit is None:
            continue
        enc, row, call, r = hit
        g, bad = ref_serve.encode_gap(
            tok_w, torch.as_tensor(enc["seeds"][row:row + 1], device=device),
            torch.as_tensor(enc["tokens"][row]), cfg["tokenizer"]["downscale_steps"])
        enc_gap, fault_enc_gap = max(enc_gap, g), min(fault_enc_gap, bad)
        by_call.setdefault(id(call), (call, []))[1].append(r)
    judge_ = ref_serve.RolloutJudge(cfg, den_w, tok_w, device, float(check["tau"]))
    out = {"draw_gap": 0.0, "pixel_gap": 0.0, "control_gap": 0.0, "judged": 0,
           "fault_draw_gap": math.inf, "fault_pixel_gap": math.inf}
    for call, rows in by_call.values():
        r = judge_.judge(call, torch.as_tensor(sorted(rows), device=device))
        for key in ("draw_gap", "pixel_gap", "control_gap"):
            out[key] = max(out[key], r[key])
        for key in ("fault_draw_gap", "fault_pixel_gap"):
            out[key] = min(out[key], r[key])
        out["judged"] += r["judged"]
    out["enc_gap"], out["fault_enc_gap"] = enc_gap, fault_enc_gap
    out["unmatched"] = sum(hit is None for hit in found)
    out["unjudged_share"] = 1.0 - out["judged"] / (len(sample) * cfg["serve"]["num_frames"])
    return out
