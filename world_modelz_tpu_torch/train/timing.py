"""End-to-end trainer timing: host buckets, fenced windows, device probes.

Port of ``world_modelz_tpu.train.timing``, shared by the video and sparse
trainer loops (``cli/video_diffusion.py``, ``cli/sparse_diffusion.py``,
``--timing_report``); the report has the JAX package's keys and
arithmetic.

- **Buckets** are host-blocking wall time: ``data`` (prefetch-queue
  wait), ``dispatch`` (enqueueing a dispatch's steps: input copies, draws,
  graph replays), ``device_wait`` (value fences blocked on device
  compute: the dispatch's stats read), ``log``, ``checkpoint``, ``eval``,
  ``probe`` (measurement overhead).
- **Window** edges are value fences (a value read back from the device).
- **Device probes**: every ``probe_interval`` steps the loop isolates one
  dispatch behind value fences, giving the device milliseconds per step
  inside the same run; the report reconciles ``device_pct`` + host buckets
  against 100% of the wall.
- **H2D probes** (``data/prefetch.py`` ``probe_every``): the prefetch
  worker fences one host-to-device copy now and then.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

HOST_BUCKETS = ("data", "dispatch", "device_wait", "log", "checkpoint",
                "eval", "probe")


class TrainTiming:
    """Bucketed timers + a fenced steps/sec window + probe records."""

    def __init__(self, probe_interval: int = 0):
        self.timers: Dict[str, float] = {b: 0.0 for b in HOST_BUCKETS}
        self.win: Dict[str, Any] = {
            "step": None, "time": None, "steps": 0, "secs": 0.0,
        }
        self.probe_interval = int(probe_interval)
        # fenced-dispatch device timings: (n_steps, seconds)
        self.probes: List[Tuple[int, float]] = []

    # -- buckets ---------------------------------------------------------
    def add(self, bucket: str, dt: float) -> None:
        self.timers[bucket] += dt

    # -- window (value-fence anchored) -----------------------------------
    def open_window(self, step: int, now: float) -> None:
        self.win["step"], self.win["time"] = step, now
        self.win["timers0"] = dict(self.timers)
        self.win["probes0"] = len(self.probes)

    @property
    def opened(self) -> bool:
        return self.win["step"] is not None

    def close_window(self, step: int, now: float) -> None:
        self.win["steps"] = step - self.win["step"]
        self.win["secs"] = now - self.win["time"]
        self.win["timersN"] = dict(self.timers)
        self.win["probesN"] = len(self.probes)

    # -- probes -----------------------------------------------------------
    def probe_due(self, step: int) -> bool:
        return self.probe_interval > 0 and step % self.probe_interval == 0

    def record_probe(self, n_steps: int, secs: float) -> None:
        self.probes.append((n_steps, secs))

    # -- report ------------------------------------------------------------
    def report(
        self,
        *,
        batch_size: int,
        config: Dict[str, Any],
        extra: Optional[Dict[str, Any]] = None,
        h2d_stats: Optional[Dict[str, Any]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Assemble the timing-report dict (None if no window closed)."""
        win = self.win
        if not win["steps"] or "timersN" not in win:
            return None
        total = max(win["secs"], 1e-9)
        sps = win["steps"] / total
        pct = {
            k: round(
                100.0 * (win["timersN"][k] - win["timers0"][k]) / total, 1
            )
            for k in self.timers
        }
        report: Dict[str, Any] = {
            "batch_size": batch_size,
            **(extra or {}),
            "window_steps": win["steps"],
            "window_secs": round(win["secs"], 3),
            "steps_per_sec": round(sps, 3),
            "samples_per_sec": round(sps * batch_size, 1),
            "breakdown_note": (
                "host-blocking wall shares; device_wait is the host blocked "
                "on device compute at value fences (device time seen from "
                "the host, NOT host overhead)"
            ),
            "breakdown_pct": pct,
        }
        # reconciliation: probed device ms/step explains the wall the host
        # buckets cannot (device compute overlapped with nothing visible)
        probes = self.probes[win.get("probes0", 0):win.get("probesN", None)]
        if probes:
            per_step = sorted(s / n for n, s in probes)
            med = per_step[len(per_step) // 2]
            probe_steps = sum(n for n, _ in probes)
            # device time during probe dispatches is already inside the
            # 'probe' host bucket; count the remaining steps at the probed
            # rate. device_wait is EXCLUDED from the host side of the sum —
            # it is device time observed from the host (double counting).
            device_pct = 100.0 * med * (win["steps"] - probe_steps) / total
            host_pct = sum(
                v for k, v in pct.items() if k != "device_wait"
            )
            report["probe"] = {
                "n_probes": len(probes),
                "device_ms_per_step": round(med * 1e3, 3),
                "device_steps_per_sec": round(1.0 / max(med, 1e-9), 3),
                "note": (
                    "fenced isolated dispatches: device compute + one relay "
                    "roundtrip, data already on device"
                ),
            }
            report["reconciliation"] = {
                "device_pct": round(device_pct, 1),
                "host_pct_excl_device_wait": round(host_pct, 1),
                "accounted_pct": round(device_pct + host_pct, 1),
                "note": (
                    "accounted = probed device share + host buckets "
                    "(device_wait excluded: it IS device time); ~100 means "
                    "no mystery wall time, >100 means probe overlap "
                    "conservatism"
                ),
            }
        if h2d_stats:
            report["h2d"] = h2d_stats
        report["config"] = config
        return report

    def write(self, path: str, report: Optional[Dict[str, Any]]) -> None:
        if not path or report is None:
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
        print("timing report:", path, report["steps_per_sec"], "steps/s")


def fence_value(x) -> None:
    """Block until tensor ``x``'s value is computed and landed: one element
    read back to the host (``.item()``), so a large buffer is not copied
    just to fence it. None and non-tensors pass."""
    if x is None or not hasattr(x, "dtype") or not x.numel():
        return
    x.reshape(-1)[0].item()
