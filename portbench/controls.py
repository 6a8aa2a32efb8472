"""The readings that a training cell's limits are set from, on the chip.

    python3 portbench/controls.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds 2] [--out <file.jsonl>]

runs the cell once per seed in this process (its runner, a short window)
and, for each, compares with the reference in the configuration's
precision: the program (the sound reading), the reference one precision
lower in the program's place (``control``: fp8 for the bf16 trainers), and
the reference with half the batch left out (``half_batch``). A step that leaves the state unchanged reads
a change_gap of 1 by construction and needs no run. Run one seed a
process on the card: a process that runs many leaves the allocator's
cache fragmented. One JSON line a seed goes to ``--out`` and standard output.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import loader  # noqa: E402
from portbench.run import _environment  # noqa: E402

VARIANTS = {"control": {"precision": "fp8"}, "half_batch": {"fraction": 0.5}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    _environment()
    cell = loader.workload(args.workload)
    cfg = loader.config(cell["config"])
    runner = loader.runner(cell["runner"])
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        res = runner.run(cell, cfg, seed=seed, seconds=args.seconds, trace=False,
                         t0=time.perf_counter(), variants=VARIANTS)
        line = {"workload": cell["name"], "seed": seed, "correct": res["correct"],
                "sound": {n: v for n, v, _ in res["checks"]}, **res["variants"],
                "info": res["info"]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
