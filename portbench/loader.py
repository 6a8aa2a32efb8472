"""Find a cell's files by name.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its runner (``runners/<runner>.py``) and
carries its traffic and the limits of its comparison. A per-layer metric
is the reader ``metrics/<metric>.py`` with a ``read(ctx)`` function. The
metrics a cell reports are those of ``BENCHMARK.json`` that list the cell
(or list none) among their ``workloads``. Nothing here knows a cell,
configuration or metric by name: a later cell is files and entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str, what: str = "name") -> str:
    """``name`` if it is a valid name (a letter, digit or _ first, then at
    most 63 of letters, digits, _, . and -), else ValueError."""
    if not isinstance(name, str) or not NAME.match(name) or ".." in name:
        raise ValueError(f"invalid {what} {name!r}")
    return name


def _json(folder: str, name: str, what: str) -> Dict:
    path = os.path.join(HERE, folder, check_name(name, what) + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {what} {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> Dict:
    cell = _json("workloads", name, "workload")
    if cell.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {cell.get('name')!r}")
    return cell


def config(name: str) -> Dict:
    cfg = _json("configs", name, "configuration")
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def runner(name: str):
    """The module ``portbench.runners.<name>``."""
    check_name(name, "runner")
    if "." in name:
        raise ValueError(f"invalid runner {name!r}")
    return importlib.import_module(f"portbench.runners.{name}")


def metric_reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", check_name(name, "metric") + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries of ``bench`` the cell
    reports: those that list it under ``workloads`` or list none. A
    per-layer metric without a list is reported where its end-to-end
    metric is."""
    out = []
    e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")} if kind == "per_layer" else None
    for m in bench[kind]:
        cells = m.get("workloads")
        if cells is not None:
            if cell in cells:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out
