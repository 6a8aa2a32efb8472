"""What the training runners share: the measured window, the per-leaf
readings of the program's optimizer state, and the comparison with the
reference's steps.

The comparison (three numbers, each with its limit in the cell's file):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first step's gradient, as the optimizer took it
  (Adam's first moment after one step over (1 - b1)), by the worst leaf:
  the gap between the program's and the reference's norm of the leaf,
  over the larger of the reference's norm of it and of the median leaf;
- ``change_gap``: the same for each leaf's change over the checked steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone under Adam).
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.trace import Slice

ADAM_B1 = 0.9


def measure(dispatch: Callable[[], int], seconds: float, trace: bool,
            trace_seconds: float) -> Tuple[int, float, Optional[Slice]]:
    """Run ``dispatch`` (one dispatch ending on a host read; returns its
    steps) until ``seconds`` have passed; with ``trace``, the dispatches of
    ``trace_seconds`` from the window's middle run under the profiler (its
    own start, which takes a while, not counted in them). Returns (steps,
    the window's wall seconds, the reduced slice)."""
    t0 = time.perf_counter()
    steps, sl, traced, tracing = 0, None, False, False
    start_trace = max(0.0, 0.5 * (seconds - trace_seconds))
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if not traced and now - t0 >= start_trace:
            traced = tracing = True
            sl = Slice().__enter__() if trace else None
            trace_t0 = time.perf_counter()
        elif tracing and now - trace_t0 >= trace_seconds:
            tracing = False
            if sl is not None:
                sl.__exit__(None, None, None)
        with torch.profiler.record_function("portbench.dispatch"):
            n = dispatch()
        steps += n
        if tracing and sl is not None:
            sl.units += n
    if tracing and sl is not None:
        sl.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    return steps, wall, sl.reduce() if sl is not None else None


def leaf_norms(flat: torch.Tensor, layout: List[Tuple[str, int]], scale: float = 1.0
               ) -> Dict[str, float]:
    """Norm of each leaf of a flat f32 buffer laid out as (name, numel)."""
    out, at = {}, 0
    for name, n in layout:
        out[name] = float(torch.linalg.vector_norm(flat[at:at + n].double())) * scale
        at += n
    return out


def _worst(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    names = [n for n in ref if keep is None or keep(n)]
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers; ``prog`` and ``ref`` hold ``loss`` (per step),
    ``grad1`` and ``change`` (per leaf)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    g_median = statistics.median(ref["grad1"].values())
    return {
        "loss_gap": loss_gap,
        "grad_gap": _worst(prog["grad1"], ref["grad1"]),
        "change_gap": _worst(prog["change"], ref["change"],
                             keep=lambda n: ref["grad1"][n] >= 1e-3 * g_median),
    }


def checks(numbers: Dict[str, float], limits: Dict[str, float]):
    return [(name, numbers[name], float(limits[name])) for name in limits]


def free_cuda() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def device_record(device, chips: int, peak: int, sl: Optional[Slice]) -> Dict:
    rec = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if sl is not None:
        rec.update(busy_s=sl.busy_s, window_s=sl.window_s)
    return rec


def reference_precision():
    """The plain references run with TF32 off (set process-wide once the
    program's window is over)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def result(cell: Dict, cfg: Dict, device, prog: Dict, ref: Dict, steps: int, failed: int,
           wall: float, setup_s: float, peak: int, sl: Optional[Slice], batch: int) -> Dict:
    """A training run's result for ``run.py``: the end-to-end numbers, the
    comparison with its limits, and the readers' context."""
    found = compare(prog, ref)
    limits = cell["limits"]
    correct = all(prog["ok"]) and all(found[n] <= float(v) for n, v in limits.items())
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ctx = {"cell": cell, "config": cfg, "trace": sl, "chips": 1, "batch": batch, "kind": kind}
    return {
        "correct": correct, "attempted": steps, "failed": failed,
        "metrics": {"train_samples_per_s": steps * batch / wall, "setup_s": setup_s},
        "device": device_record(device, 1, peak, sl),
        "breakdown": sl.breakdown() if sl else None,
        "checks": checks(found, limits), "ctx": ctx, "program": prog, "reference": ref,
        "info": {"setup_s": setup_s, "window_s": wall, "steps": steps,
                 "trace_costs_s": [sl.start_cost_s, sl.stop_cost_s] if sl else None,
                 "samples_per_s": steps * batch / wall, "loss": prog["loss"],
                 "reference_loss": ref["loss"]},
    }


def variant_steps(kept: List[Dict], variant: Dict) -> List[Dict]:
    """The checked steps' inputs as a variant of the reference takes them:
    with ``fraction``, that leading share of every row-indexed input (a
    half: the fault of a step that leaves out half the batch and takes the
    mean over the rest)."""
    frac = variant.get("fraction")
    if not frac:
        return kept
    return [{k: v[: int(v.shape[0] * frac)] for k, v in d.items()} for d in kept]
