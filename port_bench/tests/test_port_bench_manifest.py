"""BENCHMARK.json against the contract's form, discovery by name, and the
benchmark's imports."""

import ast
import json
import os
import re
import shutil

import pytest

import tiny
from benchlib import runner
from benchlib.manifest import Manifest, readers_for
from benchlib.readers import Readings

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_form(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"]
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_texts(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("port_bench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(tiny.ROOT, c["file"]))
        names.append(c["name"])
    cells = []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and TEXT.match(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["source"] in SOURCES
        assert set(m["workloads"]) <= set(cells)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_has_its_files_and_metrics(bench):
    man = Manifest(tiny.ROOT)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = man.cell(w["name"])
        e2e = {m["name"] for m in man.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = man.per_layer(cell)
        assert per_layer and all(m["moves"] in e2e for m in per_layer)
        assert man.config(cell) and man.limits(cell)
        assert hasattr(man.driver(man.traffic(cell)), "Driver")
        assert set(readers_for(man, cell)) == {m["name"] for m in per_layer}


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    """A later PR adds a cell, a configuration and a per-layer metric as new
    files and manifest entries; nothing else changes, and a run finds them."""
    man = tiny.make_bench(str(tmp_path))
    bench = man.bench_dir
    with open(os.path.join(bench, "configs", "added.json"), "w") as f:
        json.dump(dict(tiny.config("tiny_cifar"), name="added"), f)
    with open(os.path.join(bench, "traffic", "added_mix.json"), "w") as f:
        json.dump(dict(tiny.TRAFFIC["tiny_ensemble"], members=3), f)
    with open(os.path.join(bench, "limits", "added_cell.json"), "w") as f:
        json.dump({"limits": {k: {"limit": v} for k, v in tiny.TRAIN_LIMITS.items()}}, f)
    with open(os.path.join(bench, "metrics", "units_done.train.py"), "w") as f:
        f.write("def read(r):\n    return float(r.units)\n")
    with open(os.path.join(man.root, "BENCHMARK.json")) as f:
        data = json.load(f)
    data["configs"].append({"name": "added", "source": "tests", "reduced": [], "why": "tests",
                            "file": "port_bench/configs/added.json"})
    data["workloads"].append({"name": "added_cell", "config": "added", "traffic": "added_mix",
                              "chips": 1, "why": "tests"})
    data["end_to_end"][0]["workloads"].append("added_cell")
    data["per_layer"].append({"name": "units_done.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "tests",
                              "moves": "member_steps_per_s", "workloads": ["added_cell"]})
    with open(os.path.join(man.root, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)
    man = Manifest(man.root, bench)
    cell = man.cell("added_cell")
    assert man.config(cell)["name"] == "added" and man.traffic(cell)["members"] == 3
    assert readers_for(man, cell)["units_done.train"](Readings(units=4, wall_s=1.0)) == 4.0
    result = runner.run(tiny.ROOT, "added_cell", 5, 0.2, True, require_chip=False,
                        device="cpu", manifest=man)
    assert result["correct"] and result["metrics"]["units_done.train"]["value"] >= 2


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args[:1] if isinstance(a, ast.Constant))


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: the program's own name begins with the
    JAX package's."""
    for dirpath, _, files in os.walk(tiny.BENCH_DIR):
        for name in files:
            if name.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, name)):
                    assert mod.split(".")[0] not in runner.FORBIDDEN, (name, mod)
    assert runner.PORT.startswith(runner.FORBIDDEN[-1])
    assert runner.PORT.split(".")[0] not in runner.FORBIDDEN


def test_the_benchmark_alone_is_not_enough(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    has no program: a run there raises before any result."""
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.BENCH_DIR, tmp_path / "port_bench")
    with pytest.raises(runner.RunError):
        runner.import_port(str(tmp_path))
