"""The benchmark of world_modelz_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

loads the cell (``portbench/workloads/<cell>.json``), its configuration and
its runner, sets up from ``--seed`` (weights made on the card, the kernel
library from the checkout's build cache), measures for ``--seconds``, checks
what the timed path produced against the plain reference
(``portbench/reference``), and prints as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics from a profiled slice
of the window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit, which also close the
standard error. Without a CUDA card, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result. It exits with code 3
if the JAX package or JAX itself was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "world_modelz_tpu")


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no library of the run
    loads JAX or TensorFlow by itself."""
    build = os.path.join(ROOT, "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from portbench import loader

    cell = loader.workload(args.workload)
    cfg = loader.config(cell["config"])
    bench = loader.benchmark()
    runner = loader.runner(cell["runner"])

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    res = runner.run(cell, cfg, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), t0=T0)

    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3

    out = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]),
           "failed": int(res["failed"])}
    metrics = {}
    if args.trace:
        for m in loader.cell_metrics(bench, cell["name"], "per_layer"):
            value = loader.metric_reader(m["name"])(res["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in loader.cell_metrics(bench, cell["name"], "end_to_end"):
            if m["name"] in res["metrics"]:
                metrics[m["name"]] = {"value": float(res["metrics"][m["name"]]),
                                      "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = res["device"]
    if args.trace and res.get("breakdown"):
        out["breakdown"] = res["breakdown"]
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in res["checks"]}
    print(f"portbench: {cell['name']} seed {args.seed} trace {args.trace}: "
          f"{json.dumps(res['info'])}", file=sys.stderr)
    for name, v, lim in res["checks"]:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
