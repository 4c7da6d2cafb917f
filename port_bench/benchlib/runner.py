"""One run of one cell, from set-up to the result line.

1. Set-up: the driver makes every input from the seed, builds the program,
   drives it through the checked first steps or a warm-up, and leaves every
   shape of the cell's traffic warm. ``setup_s`` is the time from the
   process's start to the window's start.
2. The window: whole units of work until ``--seconds`` have passed; it ends
   at the first unit boundary after that, with a synchronise. Rates are the
   work completed over that wall time.
3. With ``--trace 1``: a `torch.profiler` window of a few more units, read
   into the per-layer metrics (an untraced window comes first and gives
   ``mfu`` and the host spans).
4. The program's state is freed, and the plain reference judges what the
   program produced (`compare`).
5. The result line: ``correct``, ``attempted``, ``failed``, ``metrics``,
   ``device``, ``breakdown`` (traced runs) and ``checks`` last, each number
   compared beside its limit. The same numbers go to standard error as its
   last lines.

No result is printed, and the exit code is not 0, when the card or the
cards the cell asks for are missing, when the program is not in the
checkout, or when the process holds JAX or the JAX package once the
window has closed.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

from . import compare, peaks
from .manifest import Manifest, readers_for
from .models import sync
from .readers import Readings
from .trace import profile

PORT = "group_attribution_for_diffusion_models_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "group_attribution_for_diffusion_models_tpu")


class RunError(RuntimeError):
    """A run that prints no result."""


@dataclasses.dataclass
class Context:
    """What a driver is handed: the run's seed and device, its cell's
    configuration and traffic, and the program's package."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    port: object  # the program's package, imported from the checkout


def process_start() -> float:
    """The process's start on the wall clock, from /proc (10 ms ticks)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold, compared
    whole: the program's own name begins with the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def import_port(root: str):
    """The program's package, from the checkout at `root` and nowhere else."""
    import importlib

    if root not in sys.path:
        sys.path.insert(0, root)
    try:
        port = importlib.import_module(PORT)
    except ImportError as e:
        raise RunError(f"the program ({PORT}) is not in {root}: {e}") from None
    where = os.path.realpath(os.path.dirname(port.__file__))
    if not where.startswith(os.path.realpath(root) + os.sep):
        raise RunError(f"{PORT} was imported from {where}, outside the checkout {root}")
    return port


def set_numerics(torch, config: dict) -> None:
    p = config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = p["allow_tf32"]
    torch.backends.cudnn.allow_tf32 = p["allow_tf32"]
    torch.backends.cudnn.deterministic = p["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = False


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        require_chip: bool = True, device: str = "cuda", manifest: Optional[Manifest] = None,
        started: Optional[float] = None) -> Dict[str, object]:
    """One run; returns the result line's object. `require_chip` False and a
    CPU `device` serve the tests, which drive a run without a card."""
    started = process_start() if started is None else started
    import torch

    manifest = manifest or Manifest(root)
    cell = manifest.cell(workload)
    if require_chip:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{workload} asks for {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} found")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    config, traffic, limits = manifest.config(cell), manifest.traffic(cell), manifest.limits(cell)
    port = import_port(root)
    set_numerics(torch, config)
    torch.set_num_threads(2)
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=seed, device=dev, port=port)
    driver = manifest.driver(traffic).Driver(ctx)

    driver.setup()
    sync(dev)
    setup_s = time.time() - started
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    win = driver.window(seconds)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary, traced_units, flops = None, 0, None
    if trace:
        traced_units, summary = profile(driver.traced, dev)
        flops = driver.flops_per_unit()
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check()
    correct = compare.judge(numbers, limits) and win["failed"] == 0

    if trace:
        readings = Readings(
            units=win["units"], wall_s=win["wall_s"], spans=win["spans"], flops_per_unit=flops,
            peak_flops=peaks.STEP_PEAK_FLOPS[config["precision"]["dtype"]],
            window_peak_bytes=window_peak, trace=summary, traced_units=traced_units)
        metrics, read = {}, readers_for(manifest, cell)
        for m in manifest.per_layer(cell):
            value = read[m["name"]](readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win["rates"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(cell)}
    found = forbidden_modules()
    if found:
        raise RunError(f"the process holds {found} after the window")
    result = {
        "correct": bool(correct), "attempted": win["attempted"], "failed": win["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": cell["chips"], "memory_peak_bytes": max(setup_peak, window_peak),
            "power_limit_w": power_limit_w() if cuda else None,
        },
    }
    if trace:
        result["device"].update(busy_s=summary.busy_us / 1e6, window_s=summary.wall_us / 1e6)
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.top_gaps()}
        # Beside the traced kernel events, so that lost profiler records show.
        result["_notes"] = {"untraced_launches": summary.untraced,
                            "launch_counts": port.ops.launch_counts() if cuda else None}
    result["checks"] = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in numbers.items()}
    return result


def report(result: Dict[str, object]) -> None:
    """The numbers compared, as the last lines of standard error, then the
    result as the last line of standard output (a traced run's launch counts
    on the line before it)."""
    notes = result.pop("_notes", None)
    if notes is not None:
        print(json.dumps({"notes": notes}), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
