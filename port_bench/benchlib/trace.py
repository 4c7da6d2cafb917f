"""The traced window: a `torch.profiler` trace of a few units of work, and
its reading.

`profile(fn)` traces one call of `fn` inside a ``bench::traced`` range that
ends with a device synchronise, exports the Chrome trace into a temporary
directory, reads it and deletes it. `summarize(events)` keeps what the
per-layer readers need:

* the device's kernels, copies and fills inside the range, each with its
  category and, for the program's own kernels, the ``gadm::<kernel>(dims)``
  range its launch ran in;
* the union of their intervals (busy time) and the range's length (the
  traced wall time);
* the idle gaps between them, each named by the host range that was open on
  the traced thread in its middle;
* launch calls whose kernel has no record in the trace.

A kernel's launching host ranges are found as the program's own profile
reader finds them: the runtime call that carries the kernel's correlation
id, then the host ranges open on that call's thread at its start. The
categories follow the same rules: the program's kernels by their symbols,
then ``convolution`` (a kernel under an aten convolution, or a cuDNN name),
``gemm``, ``memcpy/memset`` and ``other``.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import shutil
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .models import sync

RANGE = "bench::traced"
# Symbol of a kernel of the program -> the name its launch range carries.
KERNEL_SYMBOLS = {
    "attention_fwd_kernel": "attention_fwd",
    "attention_bwd_dq_kernel": "attention_bwd_dq",
    "attention_bwd_dkv_kernel": "attention_bwd_dkv",
    "group_norm_fwd_flat": "group_norm_fwd",
    "group_norm_fwd_stream": "group_norm_fwd",
    "group_norm_bwd_flat": "group_norm_bwd",
    "group_norm_bwd_stream": "group_norm_bwd",
    "jl_partial_kernel": "jl_projection",
    "jl_reduce_kernel": "jl_projection_reduce",
}
_SYMBOL = re.compile(r"\b(" + "|".join(KERNEL_SYMBOLS) + r")\b")
_LAUNCH = re.compile(r"^gadm::(\w+)\((.*)\)$")
_CONV_OP = re.compile(r"^aten::(conv|_conv|cudnn_conv|mkldnn_conv|slow_conv|thnn_conv)")
_GEMM_OP = re.compile(r"^aten::(mm|addmm|bmm|baddbmm|matmul|linear|addmv|mv|dot|_addmm)\b")
_CONV_NAME = re.compile(r"conv|cudnn|implicit_gemm|implicit_convolve|xmma_(fprop|dgrad|wgrad)"
                        r"|dgrad|wgrad|winograd")
_GEMM_NAME = re.compile(r"gemm|gemv|cublas|cutlass")
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    dur_us: float
    category: str
    launch: Optional[Tuple[str, str]] = None  # (kernel, dims) of its gadm:: range


@dataclass
class TraceSummary:
    events: List[DeviceEvent] = field(default_factory=list)
    busy_us: float = 0.0
    wall_us: float = 0.0
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host range, us)
    untraced: Dict[str, int] = field(default_factory=dict)

    def category_us(self, category: str) -> float:
        return sum(e.dur_us for e in self.events if e.category == category)

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time: [[name, seconds], ...]."""
        by: Dict[str, float] = defaultdict(float)
        for e in self.events:
            by[e.name[:160]] += e.dur_us
        return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[list]:
        """Idle time by what the host was doing: [[host range, seconds], ...]."""
        by: Dict[str, float] = defaultdict(float)
        for name, us in self.gaps:
            by[name[:160]] += us
        return [[k, v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e.get("dur", 0.0))


class _HostRanges:
    """Each thread's host ranges, swept in time order, so that the ranges open
    on a thread at a time can be asked for."""

    def __init__(self, events: List[dict]):
        by_tid: Dict[tuple, list] = defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in _HOST:
                by_tid[(e.get("pid"), e.get("tid"))].append(e)
        self.by_tid, self.chains, self.starts = {}, {}, {}
        for key, evs in by_tid.items():
            evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
            stack: List[dict] = []
            for e in evs:
                while stack and _end(stack[-1]) <= float(e["ts"]):
                    stack.pop()
                self.chains[id(e)] = list(stack)
                stack.append(e)
            self.by_tid[key] = evs
            self.starts[key] = [float(e["ts"]) for e in evs]

    def open_at(self, key: tuple, ts: float) -> List[dict]:
        """Ranges of thread `key` open at `ts`, outermost first."""
        evs = self.by_tid.get(key)
        if not evs:
            return []
        i = bisect.bisect_right(self.starts[key], ts)
        if i == 0:
            return []
        last = evs[i - 1]
        return [r for r in self.chains[id(last)] + [last] if _end(r) >= ts]


def _category(name: str, chain: List[dict], cat: str) -> Tuple[str, Optional[Tuple[str, str]]]:
    sym = _SYMBOL.search(name)
    if sym:
        kernel = KERNEL_SYMBOLS[sym.group(1)]
        launch = next((m for r in reversed(chain) if (m := _LAUNCH.match(r.get("name", "")))),
                      None)
        if launch and launch.group(1) == kernel:
            return kernel, (kernel, launch.group(2))
        return kernel, None
    if cat != "kernel":
        return "memcpy/memset", None
    ops = [r.get("name", "") for r in chain if r.get("cat") == "cpu_op"]
    if any(_CONV_OP.match(o) for o in ops) or _CONV_NAME.search(name):
        return "convolution", None
    if any(_GEMM_OP.match(o) for o in ops) or _GEMM_NAME.search(name):
        return "gemm", None
    return "other", None


def summarize(events: List[dict]) -> TraceSummary:
    """The reading of one Chrome trace (module docstring)."""
    window = next((e for e in events if e.get("ph") == "X" and e.get("name") == RANGE), None)
    if window is None:
        raise ValueError(f"the trace has no {RANGE} range")
    w0, w1 = float(window["ts"]), _end(window)
    thread = (window.get("pid"), window.get("tid"))
    host = _HostRanges(events)  # host ranges and runtime calls, by thread
    runtime = {(e.get("args") or {}).get("correlation"): e for e in events
               if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")}
    out = TraceSummary(wall_us=w1 - w0)
    spans = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE:
            continue
        start, stop = max(float(e["ts"]), w0), min(_end(e), w1)
        if stop <= start:
            continue
        call = runtime.get((e.get("args") or {}).get("correlation"))
        chain = (host.open_at((call.get("pid"), call.get("tid")), float(call["ts"]))
                 if call is not None else [])
        category, launch = _category(e.get("name", ""), chain, e["cat"])
        out.events.append(DeviceEvent(e.get("name", ""), start, stop - start, category, launch))
        spans.append((start, stop))
    spans.sort()
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out.busy_us = sum(b - a for a, b in merged)
    # Idle gaps, named by what the traced thread was in at their middle.
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            chain = [r for r in host.open_at(thread, (a + b) / 2) if r is not window]
            out.gaps.append((chain[-1].get("name", "?") if chain else "host (no range)", b - a))
    traced = {(e.get("args") or {}).get("correlation") for e in events
              if e.get("ph") == "X" and e.get("cat") in _DEVICE}
    untraced: Dict[str, int] = defaultdict(int)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "") and w0 <= float(e["ts"]) <= w1
                and (e.get("args") or {}).get("correlation") not in traced):
            chain = host.open_at((e.get("pid"), e.get("tid")), float(e["ts"]))
            launch = next((m for r in reversed(chain) if (m := _LAUNCH.match(r.get("name", "")))),
                          None)
            op = next((r["name"] for r in reversed(chain) if r.get("cat") == "cpu_op"), "?")
            untraced[launch.group(1) if launch else op] += 1
    out.untraced = dict(untraced)
    return out


def profile(fn: Callable[[], object], device) -> Tuple[object, TraceSummary]:
    """Trace one call of `fn` (CPU and CUDA activity) and read the trace.

    As the program's own tracer does, a warm-up step runs before the
    recording one, then a marker launch and half a second of host time, so
    that collection is on before the traced range opens (on an H100 the
    records of a window's first launches have gone missing otherwise)."""
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    tmp = tempfile.mkdtemp(prefix="port_bench_trace_")
    try:
        with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
            prof.step()
            torch.ones(1, device=device).add_(1)
            sync(device)
            time.sleep(0.5)
            with torch.profiler.record_function(RANGE):
                result = fn()
                sync(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return result, summarize(events)
