"""Training-scalar trackers: ``none`` and ``jsonl``.

Port of the JAX package's ``utils/trackers.py`` for the two kinds that need
no optional package (its wandb and tensorboard kinds come later).
`make_tracker(kind, ...)` returns an object with ``.log(metrics, step)`` and
``.finish()``; a JSONL tracker appends one {"step", "ts", **metrics} row per
call as a single O_APPEND write, after a {"event": "config", ...} row.
"""

from __future__ import annotations

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
    run_name: Optional[str] = None,
    config: Optional[Dict] = None,
    logdir: Optional[str] = None,
):
    """kind none | jsonl; the JSONL file is <logdir>/<run_name>.jsonl."""
    if kind == "none":
        return NullTracker()
    if kind == "jsonl":
        path = os.path.join(logdir or ".", f"{run_name or 'metrics'}.jsonl")
        return JsonlTracker(path, config)
    raise ValueError(f"unknown or not yet ported tracker kind: {kind!r}")
