"""Tracing and structured timing.

Port of the JAX package's ``utils/profiling.py``: `Timings` as it is; a
`torch.profiler` trace in place of ``jax.profiler``'s, wrapped around any
hot region with `trace(logdir)` and read with `utils.device_profile` (or
TensorBoard's PyTorch profiler plugin, or chrome://tracing); and
`annotate(name)`, a named range in that trace (``record_function``).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Callable, Dict, Iterator, Optional

import torch


class Timings:
    """Accumulate named wall-clock segments; dict-dumpable into JSONL rows."""

    def __init__(self):
        self._acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self._acc[name] = self._acc.get(name, 0.0) + time.time() - t0

    def as_dict(self, prefix: str = "") -> Dict[str, float]:
        return {f"{prefix}{k}_time": round(v, 4) for k, v in self._acc.items()}


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, device=None) -> Iterator[None]:
    """torch.profiler trace of the block, exported as one Chrome trace
    ``<host>_<pid>.<ns>.pt.trace.json`` into `logdir`; a no-op when `logdir`
    is None. CPU activity always, with the ops' input shapes and FLOPs;
    CUDA activity when the work runs on a CUDA `device` (default: when CUDA
    is available). Each op's FLOPs (``with_flops``) go into its event's
    ``args["flops"]``. The profiler's start and the export run outside the
    block, so a caller that reads its clock inside the block leaves them out
    of its timing."""
    if logdir is None:
        yield
        return
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    # A warm-up step before the recording one, so that activity collection is
    # on before the window opens, then a marker launch and half a second of
    # host time before the block. On an H100 the kernel records of a window's
    # first launches go missing now and then (their launch calls stay in the
    # trace: `device_profile.untraced_launches`). In short processes the
    # marker's records were the ones lost; after twelve minutes of one, up to
    # 60 records were lost all the same.
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities, schedule=schedule, record_shapes=True,
                                with_flops=True) as prof:
        prof.step()
        if cuda:
            torch.ones(1, device=device if device is not None else "cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.5)
        yield
    path = os.path.join(logdir,
                        f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    # The exported events leave out the FLOPs with_flops counts: each op's
    # count goes into its event's args, keyed by the event's External id.
    flops = {e.id: e.flops for e in prof.events() if e.flops}
    if flops:
        with open(path) as f:
            data = json.load(f)
        for e in data.get("traceEvents", []):
            args = e.get("args") or {}
            if e.get("cat") == "cpu_op" and args.get("External id") in flops:
                args["flops"] = flops[args["External id"]]
        with open(path, "w") as f:
            json.dump(data, f)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-range (shows up in the profiler timeline)."""
    with torch.profiler.record_function(name):
        yield


def launch_scope(kernel: str, dims: Callable[[], Dict[str, object]]):
    """The range a CUDA kernel wrapper launches in while a profiler runs:
    ``gadm::<kernel>(k=v,...)`` with the launch's shape, ``dims()``, from
    which `utils.device_profile` counts the kernel's work; nothing
    otherwise, and `dims` is not called, so an unprofiled launch pays no
    annotation."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    args = ",".join(f"{k}={v}" for k, v in dims().items())
    return torch.profiler.record_function(f"gadm::{kernel}({args})")
