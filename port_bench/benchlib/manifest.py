"""Discovery by name: a cell of ``BENCHMARK.json``, its configuration,
traffic, limits and driver, and each per-layer metric's reader.

Layout, under the benchmark's directory (``port_bench/``):

* ``configs/<config>.json``: a configuration, the file ``BENCHMARK.json``
  names for it;
* ``traffic/<traffic>.json``: a traffic mix, with the ``driver`` that runs it
  and the parameters the traffic generator reads;
* ``limits/<cell>.json``: the limits of the numbers that decide a cell's
  ``correct``, each with the readings it was set from;
* ``drivers/<driver>.py``: set-up, window and check of a kind of work;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(readings)``.

A later cell, configuration or metric is a new file of one of these kinds
and an entry in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    """``BENCHMARK.json`` at `root` and the files it names under `bench_dir`."""

    def __init__(self, root: str, bench_dir: str = BENCH_DIR):
        self.root, self.bench_dir = root, bench_dir
        self.data = _json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == cell["config"])
        return _json(os.path.join(self.root, entry["file"]))

    def traffic(self, cell: dict) -> dict:
        return _json(os.path.join(self.bench_dir, "traffic", f"{cell['traffic']}.json"))

    def limits(self, cell: dict) -> dict:
        return _json(os.path.join(self.bench_dir, "limits", f"{cell['name']}.json"))["limits"]

    def driver(self, traffic: dict):
        name = traffic["driver"]
        return _module(os.path.join(self.bench_dir, "drivers", f"{name}.py"),
                       f"port_bench_driver_{name}")

    def end_to_end(self, cell: dict) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def per_layer(self, cell: dict) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        return _module(path, f"port_bench_metric_{metric.replace('.', '_')}").read


def readers_for(manifest: Manifest, cell: dict) -> Dict[str, Callable]:
    return {m["name"]: manifest.reader(m["name"]) for m in manifest.per_layer(cell)}
