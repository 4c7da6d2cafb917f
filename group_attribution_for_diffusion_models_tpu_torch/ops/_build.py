"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (nvcc, ``sm_90a``): no PyTorch headers, so a build takes
seconds. Libraries land in ``csrc/build/`` (git-ignored) under a name that
carries a hash of the source, of every header it includes with quotes
(``csrc/mma_common.cuh``), and of the flags, so an edited source or header
rebuilds and an unchanged one loads as it is. `build` starts one nvcc per
source, all together, and waits for every one; `load` builds a single
missing library at first use.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers in ``ops/`` raise when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Iterable

SOURCES = ("attention", "attention_bwd", "group_norm", "group_norm_bwd", "jl_projection")

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "build")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
        )
    return path


def source_path(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _inputs(name: str) -> list:
    """csrc/<name>.cu, then every file it includes with quotes, recursively,
    each once, in the order first reached."""
    seen, todo = [], [source_path(name)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            text = f.read()
        todo += [os.path.join(os.path.dirname(path), m.decode()) for m in _INCLUDE.findall(text)]
    return seen


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in _inputs(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in `names` that is not built yet, one nvcc per
    source, all started together. Returns {name: library path}; raises with
    the compiler's output if any build fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu exited {proc.returncode}:\n{out}")
            continue
        os.replace(tmp, paths[name])  # atomic: concurrent builds agree
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing."""
    return ctypes.CDLL(build([name])[name])


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        lib.gadm_error_string.restype = ctypes.c_char_p
        lib.gadm_error_string.argtypes = [ctypes.c_int]
        msg = lib.gadm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
