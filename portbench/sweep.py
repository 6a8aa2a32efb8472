"""Find a serving cell's knee: the highest offered rate the service keeps up
with, on the chip.

    python3 portbench/sweep.py --workload <cell> --seed <n> --rates 4 6 8 ... \\
        [--seconds 20]

builds the cell's service once, then offers its traffic at each rate for
``--seconds`` (open loop) and prints one JSON line a rate: requests
offered and completed, completions a second, the latency median and 95th
percentile, and the backlog left when the offering stopped.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import loader, traffic  # noqa: E402
from portbench.run import _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from portbench.runners import serve_m3

    cell = loader.workload(args.workload)
    cfg = loader.config(cell["config"])
    device = torch.device("cuda")
    progs, rec, svc = serve_m3.build_service(cfg, args.seed, device,
                                             float(cell["traffic"].get("max_wait_s", 0.05)))
    rec.keep = False
    seq = cfg["n_past"] + 1
    try:
        for rate in args.rates:
            n = int(round(rate * args.seconds))
            clips = traffic.clips(args.seed, n, seq, cfg["image_size"],
                                  cfg["tokenizer"]["in_channels"])
            due = traffic.arrivals(n, rate, args.seed)
            start, futures, done, _, late = serve_m3.offer(svc, clips, due, args.seconds,
                                                           False, 0.0)
            stop = time.perf_counter()
            backlog = sum(not f.done() for f in futures)
            for f in futures:
                f.result()
            lat = [d - start - at for d, at in zip(done, due)]
            in_window = sum(d <= stop for d in done)
            q95, q50 = serve_m3.quantiles(lat)
            print(json.dumps({"rate": rate, "offered": n, "completed_in_window": in_window,
                              "completed_per_s": in_window / (stop - start),
                              "p50_ms": q50 * 1e3, "p95_ms": q95 * 1e3,
                              "backlog_at_stop": backlog, "submit_late_ms": late * 1e3}),
                  flush=True)
    finally:
        svc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
