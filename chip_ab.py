#!/usr/bin/env python3
"""Time one phase of chip_smoke.py in two trees on one GPU, in turns.

    python3 chip_ab.py --parent build/parent [--phase check_local3d] [--phase-here]

Runs the phase of each tree's own ``chip_smoke.py``, each in a process of
its own from that tree's root, in the order parent, this tree, this tree,
parent, so that a drift of the card's clocks or of its host falls on both
trees alike. With ``--phase-here`` both trees run this tree's
``chip_smoke.py`` phase, each against its own package: a phase that the
parent's script lacks, which must call only what both packages have.
Each tree builds its own kernels (into its own ``build/kernels/``). The
parent is any other checkout of the repository, e.g. ``git archive
<commit> | tar -x -C build/parent``. Prints every
run's log, each line tagged with its run, then a table of the
``kernel_ms`` that the phase logged for each case and dtype in each run,
and the card's name and power limit as nvidia-smi reports them. Exits
non-zero if a run fails or there is no GPU.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

RUN = """
import importlib.util, sys, torch
sys.path.insert(0, ".")
from world_modelz_tpu_torch.kernels import _build
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.load_library()
getattr(cs, sys.argv[1])(torch, torch.device("cuda"))
"""

# "local3d_fwd <case> <dtype> ... kernel_ms=<ms>"
CASE = re.compile(r"^(\S+) (\S+) (float32|bfloat16) .*?kernel_ms=([0-9.]+)")


def run(tree: str, args, tag: str):
    """The log lines of RUN with ``args`` in ``tree``, each printed with
    ``tag``."""
    proc = subprocess.run([sys.executable, "-c", RUN, *args], cwd=tree,
                          capture_output=True, text=True, timeout=1800)
    lines = proc.stdout.splitlines()
    for line in lines:
        print(f"[{tag}] {line}", flush=True)
    if proc.returncode:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"{tag}: {' '.join(args)} failed in {tree} ({proc.returncode})")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the other tree")
    ap.add_argument("--phase", default="check_local3d",
                    help="a phase of chip_smoke.py taking (torch, device)")
    ap.add_argument("--phase-here", action="store_true",
                    help="run this tree's chip_smoke.py phase in both trees")
    args = ap.parse_args()
    parent = os.path.abspath(args.parent)
    order = [("parent", parent), ("new", HERE), ("new", HERE), ("parent", parent)]
    times = {}  # (kernel, case, dtype) -> [ms per run]
    for i, (name, tree) in enumerate(order):
        smoke = os.path.join(HERE if args.phase_here else tree, "chip_smoke.py")
        for line in run(tree, [args.phase, smoke], f"{i + 1}:{name}"):
            m = CASE.match(line)
            if m:
                key = m.group(1, 2, 3)
                times.setdefault(key, [None] * len(order))[i] = float(m.group(4))
    print("kernel case dtype: kernel_ms by run (" +
          ", ".join(f"{i + 1}:{n}" for i, (n, _) in enumerate(order)) + ")")
    for (kernel, case, dtype), ms in times.items():
        cells = " ".join("-" if x is None else f"{x:.5f}" for x in ms)
        print(f"{kernel} {case} {dtype}: {cells}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
