"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole: ``world_modelz_tpu_torch`` is the port), and the
references load nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

from portbench import loader, run

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "world_modelz_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_name_check(monkeypatch):
    monkeypatch.setitem(sys.modules, "world_modelz_tpu_torch_like.sub", sys.modules[__name__])
    assert "world_modelz_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "world_modelz_tpu.sub", sys.modules[__name__])
    assert "world_modelz_tpu" in run.forbidden_modules()


def test_sources_import_nothing_forbidden():
    for path in glob.glob(os.path.join(loader.HERE, "**", "*.py"), recursive=True):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_references_import_nothing_of_the_port():
    allowed = {"__future__", "math", "typing", "numpy", "torch", "portbench"}
    for path in glob.glob(os.path.join(loader.HERE, "reference", "*.py")):
        for name in _imports(path):
            assert name.split(".")[0] in allowed, (path, name)
            if name.startswith("portbench"):
                assert name.startswith("portbench.reference"), (path, name)


def test_loaded_modules_of_a_run():
    """Every module a run loads (entry, runners, readers, references, the
    port), in a fresh process: no forbidden top-level name."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run, loader, controls\n"
        "run._environment()\n"
        "b = loader.benchmark()\n"
        "for w in b['workloads']: loader.runner(loader.workload(w['name'])['runner'])\n"
        "for m in b['per_layer']: loader.metric_reader(m['name'])\n"
        "print(run.forbidden_modules())\n" % loader.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
