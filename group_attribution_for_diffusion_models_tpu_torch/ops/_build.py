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

`build_host` compiles the repository's host C++ sources (``native/*.cpp``,
the JSONL scanner and the image loader that ``utils/native_*.py`` bind) the
same way with g++ and ``native/Makefile``'s flags, into the same directory;
as ``-march=native`` ties a library to the CPU it was built on, its name
also hashes that CPU's model and flags.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
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


_CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")  # native/Makefile's


def _host_cpu() -> bytes:
    """The CPU a ``-march=native`` library is built for: the machine type and
    the model and flags lines of /proc/cpuinfo, where there is one."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f if ln.startswith((b"model name", b"flags"))][:2]
    except OSError:
        lines = []
    return platform.machine().encode() + b"".join(lines)


def build_host(source: str, libs: Iterable[str] = ()) -> str:
    """Compile the C++ file `source` (a plain C interface) with g++ into
    ``csrc/build/``, linked with `libs`, unless it is built already. Returns
    the library's path; raises RuntimeError naming what is missing (g++, a
    header) or with the compiler's output."""
    libs = tuple(libs)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(_CXX_FLAGS + libs).encode() + _host_cpu())
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(_BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, source, *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        missing = (re.search(r"fatal error: (\S+): No such file", proc.stderr)
                   or re.search(r"cannot find (-l\w+)", proc.stderr))
        if missing:
            raise RuntimeError(f"g++ {stem}.cpp: {missing.group(1)} is missing")
        raise RuntimeError(f"g++ {stem}.cpp exited {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builds agree
    return path


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
