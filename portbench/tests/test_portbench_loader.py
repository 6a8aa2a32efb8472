"""The loader finds every cell, configuration and metric by name, refuses
other names, and picks up a cell, configuration and metric added as files
only."""

import json
import os
import shutil

import pytest

from portbench import loader


def test_every_entry_found():
    bench = loader.benchmark()
    for c in bench["configs"]:
        cfg = loader.config(c["name"])
        assert os.path.join(loader.ROOT, c["file"]) == os.path.join(
            loader.HERE, "configs", c["name"] + ".json")
        assert cfg.get("reduced", []) == c["reduced"]
    for w in bench["workloads"]:
        cell = loader.workload(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["traffic"]["name"] == w["traffic"] and cell["why"] == w["why"]
        assert callable(loader.runner(cell["runner"]).run)
        for kind in ("end_to_end", "per_layer"):
            assert loader.cell_metrics(bench, w["name"], kind)
    for m in bench["per_layer"]:
        assert callable(loader.metric_reader(m["name"]))


@pytest.mark.parametrize("name", ["", "a b", "a/b", "../x", "x,y", ".hidden", "é", "a" * 65])
def test_bad_names_refused(name):
    with pytest.raises(ValueError):
        loader.check_name(name)
    with pytest.raises((ValueError, FileNotFoundError)):
        loader.workload(name)


def test_missing_names():
    for fn in (loader.workload, loader.config, loader.metric_reader):
        with pytest.raises(FileNotFoundError):
            fn("no_such_name.x")


def test_new_cell_added_as_files(tmp_path, monkeypatch):
    """A copy of the benchmark's folder with one more configuration, cell and
    metric, each a new file: the loader and the metric lists take them."""
    copy = tmp_path / "portbench"
    shutil.copytree(loader.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((copy / "configs" / "m3.json").read_text())
    cfg["name"] = "m3_deep"
    (copy / "configs" / "m3_deep.json").write_text(json.dumps(cfg))
    cell = json.loads((copy / "workloads" / "m3.train_b64.json").read_text())
    cell.update(name="m3_deep.train_b32", config="m3_deep")
    (copy / "workloads" / "m3_deep.train_b32.json").write_text(json.dumps(cell))
    (copy / "metrics" / "answer.train.py").write_text("def read(ctx):\n    return 42.0\n")
    monkeypatch.setattr(loader, "HERE", str(copy))
    bench = loader.benchmark()
    bench["workloads"].append({"name": "m3_deep.train_b32", "config": "m3_deep",
                               "traffic": "train_b64", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("m3_deep.train_b32")
    bench["per_layer"].append({"name": "answer.train", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "train_samples_per_s"})
    assert loader.workload("m3_deep.train_b32")["config"] == "m3_deep"
    assert loader.config("m3_deep")["dim"] == 384
    assert loader.metric_reader("answer.train")({}) == 42.0
    names = [m["name"] for m in loader.cell_metrics(bench, "m3_deep.train_b32", "per_layer")]
    assert names == ["answer.train"]
    assert "answer.train" in [m["name"] for m in
                              loader.cell_metrics(bench, "m3.train_b64", "per_layer")]
