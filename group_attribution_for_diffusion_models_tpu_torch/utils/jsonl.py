"""Append-only JSONL experiment databases.

Port of the JAX package's ``utils/jsonl.py`` with the same row format, so
the JAX package's LDS tier reads the rows the port writes. A row is
``vars(args) + scores + remaining_idx/removed_idx + timings`` (reference
unconditional_generation/main.py:790-800), appended as one write. Filtering
is the plain Python scan; the JAX package's native mmap prefilter waits for
its own port.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Mapping

import numpy as np


class _NumpyEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return super().default(o)


def append_record(db_path: str, record: Mapping[str, Any]) -> None:
    """Append one JSON row as a single O_APPEND write."""
    os.makedirs(os.path.dirname(os.path.abspath(db_path)), exist_ok=True)
    line = json.dumps(record, cls=_NumpyEncoder) + "\n"
    with open(db_path, "a", encoding="utf-8") as f:
        f.write(line)
        f.flush()


def read_records(db_path: str) -> Iterator[Dict[str, Any]]:
    """Iterate rows, skipping torn/corrupt lines."""
    if not os.path.exists(db_path):
        return
    with open(db_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def filter_records(db_path: str, condition: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """Rows matching every (key, value) in `condition` (reference lds.py:203-266)."""
    return [rec for rec in read_records(db_path)
            if all(rec.get(k) == v for k, v in condition.items())]
