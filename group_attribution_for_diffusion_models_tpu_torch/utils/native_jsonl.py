"""ctypes binding of the native JSONL scanner (the repository's
``native/jsonl_scan.cpp``).

Port of the JAX package's ``utils/native_jsonl.py``: `filter_records_native`
is the fast path of `utils.jsonl.filter_records`. The C++ library mmaps the
DB and prefilters rows on the serialized ``"key": value`` pairs of the
condition; Python parses only the candidates and checks the condition
exactly (the substring pass over-approximates). The library is built with
g++ at first use into ``csrc/build/`` (`ops._build.build_host`), never into
``native/``. Where it cannot be built (no g++), `filter_records_native`
returns None, as the JAX binding does, and callers scan in Python; that is
said once, in a warning naming what was missing.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import warnings
from typing import Any, Dict, List, Mapping, Optional

from ..ops import _build

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "jsonl_scan.cpp",
)


@functools.cache
def _library() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_build.build_host(SOURCE))
    except (RuntimeError, OSError) as e:
        warnings.warn(f"the native JSONL scanner is unavailable ({e}); "
                      "filter_records scans the DB in Python", RuntimeWarning)
        return None
    lib.jsonl_open.argtypes = [ctypes.c_char_p]
    lib.jsonl_open.restype = ctypes.c_int
    lib.jsonl_close.argtypes = [ctypes.c_int]
    lib.jsonl_close.restype = None
    lib.jsonl_count_lines.argtypes = [ctypes.c_int]
    lib.jsonl_count_lines.restype = ctypes.c_int64
    lib.jsonl_filter.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.jsonl_filter.restype = ctypes.c_int64
    lib.jsonl_read_range.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p
    ]
    lib.jsonl_read_range.restype = ctypes.c_int64
    return lib


def native_available() -> bool:
    return _library() is not None


def _condition_needles(condition: Mapping[str, Any]) -> bytes:
    """The condition as the exact '"key": value' byte patterns the DB's
    writer (json.dumps) produces, NUL-separated."""
    parts = [f'"{k}": {json.dumps(v)}'.encode() for k, v in condition.items()]
    return b"\x00".join(parts) + b"\x00"


def filter_records_native(
    db_path: str, condition: Mapping[str, Any]
) -> Optional[List[Dict[str, Any]]]:
    """Rows of `db_path` matching every (key, value) of `condition`, in file
    order; None when the library is unavailable or the DB missing or empty."""
    lib = _library()
    if lib is None or not os.path.exists(db_path) or os.path.getsize(db_path) == 0:
        return None
    fid = lib.jsonl_open(db_path.encode())
    if fid < 0:
        return None
    try:
        needles = _condition_needles(condition) if condition else b"\x00"
        cap = 4096
        while True:
            buf = (ctypes.c_int64 * (2 * cap))()
            n = lib.jsonl_filter(fid, needles, len(condition), buf, cap)
            if n < 0:
                return None
            if n <= cap:
                break
            cap = int(n)
        out: List[Dict[str, Any]] = []
        for i in range(int(n)):
            start, length = buf[2 * i], buf[2 * i + 1]
            raw = ctypes.create_string_buffer(int(length))
            lib.jsonl_read_range(fid, start, length, raw)
            try:
                rec = json.loads(raw.raw.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if all(rec.get(k) == v for k, v in condition.items()):
                out.append(rec)
        return out
    finally:
        lib.jsonl_close(fid)
