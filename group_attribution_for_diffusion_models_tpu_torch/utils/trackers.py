"""Training-scalar trackers: ``none``, ``jsonl``, ``wandb`` and ``tensorboard``.

Port of the JAX package's ``utils/trackers.py``. `make_tracker(kind, ...)`
returns an object with ``.log(metrics, step)`` and ``.finish()``; a JSONL
tracker appends one {"step", "ts", **metrics} row per call as a single
O_APPEND write, after a {"event": "config", ...} row. The wandb and
tensorboard kinds import their package (``wandb``,
``torch.utils.tensorboard``) when they are built. Where the JAX package
falls back to JSONL when the package is missing, the port fails there and
names the package: a run asked to log to one place never logs to another.
"""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Dict, Optional


class NullTracker:
    """Sink that drops everything (kind='none')."""

    def log(self, metrics: Dict, step: int) -> None:
        pass

    def finish(self) -> None:
        pass


class JsonlTracker:
    """Append one {"step", "ts", **metrics} row per log call."""

    def __init__(self, path: str, config: Optional[Dict] = None):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if config:
            self._write({"event": "config", **_jsonable(config)})

    def _write(self, row: Dict) -> None:
        data = (json.dumps(row) + "\n").encode()
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)

    def log(self, metrics: Dict, step: int) -> None:
        self._write({"step": int(step), "ts": time.time(), **_jsonable(metrics)})

    def finish(self) -> None:
        pass


def _import(kind: str, module: str, package: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"--tracker {kind} needs the {package!r} package, which is not "
                          f"installed ({e})") from None


class WandbTracker:
    def __init__(self, project: str, run_name: Optional[str], config: Optional[Dict]):
        wandb = _import("wandb", "wandb", "wandb")
        self._run = wandb.init(project=project, name=run_name, config=config)

    def log(self, metrics: Dict, step: int) -> None:
        self._run.log(_jsonable(metrics), step=int(step))

    def finish(self) -> None:
        self._run.finish()


class TensorboardTracker:
    """Scalars as TensorBoard event files under `logdir`; entries that are
    not scalars are left out, as the JAX tracker leaves them."""

    def __init__(self, logdir: str, config: Optional[Dict]):
        tensorboard = _import("tensorboard", "torch.utils.tensorboard", "tensorboard")
        self._w = tensorboard.SummaryWriter(logdir)
        if config:
            self._w.add_text("config", json.dumps(_jsonable(config)))

    def log(self, metrics: Dict, step: int) -> None:
        for k, v in metrics.items():
            try:
                self._w.add_scalar(k, float(v), int(step))
            except (TypeError, ValueError):
                pass

    def finish(self) -> None:
        self._w.close()


def _jsonable(d: Dict) -> Dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                out[k] = str(v)
    return out


def make_tracker(
    kind: str = "none",
    project: str = "group-attribution",
    run_name: Optional[str] = None,
    config: Optional[Dict] = None,
    logdir: Optional[str] = None,
):
    """kind none | jsonl (<logdir>/<run_name>.jsonl) | wandb (`project`,
    `run_name`) | tensorboard (event files under `logdir`, default
    ``tb_logs``)."""
    if kind == "none":
        return NullTracker()
    if kind == "jsonl":
        path = os.path.join(logdir or ".", f"{run_name or 'metrics'}.jsonl")
        return JsonlTracker(path, config)
    if kind == "wandb":
        return WandbTracker(project, run_name, config)
    if kind == "tensorboard":
        return TensorboardTracker(logdir or "tb_logs", config)
    raise ValueError(f"unknown tracker kind: {kind!r}")
