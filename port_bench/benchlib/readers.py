"""The arithmetic of the per-layer metrics. Each file under ``metrics/`` is
one metric's reader and calls one of these on the run's `Readings`. A reader
that finds nothing to read returns None, and the metric is left out of the
result line; none returns 0 for a share of a roofline or of a peak.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from . import peaks
from .trace import TraceSummary


@dataclass
class Readings:
    """What a traced run hands its per-layer readers.

    `units` are the window's units of work (ensemble steps, or denoise
    steps) over `wall_s` seconds of host clock ended by a synchronise;
    `spans` the benchmark's host-clock spans around each call into the step
    or model, as (seconds, units); `flops_per_unit` the model FLOPs of a unit
    counted on the plain reference; `peak_flops` the step's peak by the
    configuration's precision; `window_peak_bytes` the device's allocation
    peak over the window; `trace` the traced window, which held
    `traced_units` units."""

    units: int
    wall_s: float
    spans: List[Tuple[float, int]] = field(default_factory=list)
    flops_per_unit: Optional[float] = None
    peak_flops: float = peaks.F32_TENSOR_FLOPS
    window_peak_bytes: Optional[int] = None
    trace: Optional[TraceSummary] = None
    traced_units: int = 0


def mfu(r: Readings) -> Optional[float]:
    """The whole step's share of the chip's peak, in %."""
    if not r.flops_per_unit or not r.units or r.wall_s <= 0:
        return None
    return 100.0 * r.flops_per_unit * r.units / r.wall_s / r.peak_flops


def host_ms_per_unit(r: Readings) -> Optional[float]:
    """Host milliseconds to enqueue one unit, over every span."""
    n = sum(u for _, u in r.spans)
    return 1e3 * sum(s for s, _ in r.spans) / n if n else None


def category_ms_per_unit(r: Readings, category: str) -> Optional[float]:
    if r.trace is None or not r.traced_units:
        return None
    us = r.trace.category_us(category)
    return us / 1e3 / r.traced_units if us else None


def roofline(r: Readings, kernels: Sequence[str]) -> Optional[float]:
    """Σ least time ÷ Σ device time over the traced launches of `kernels`
    whose launch range was found, in %."""
    if r.trace is None:
        return None
    bound = time = 0.0
    for e in r.trace.events:
        if e.launch is None or e.launch[0] not in kernels:
            continue
        b = peaks.launch_bound_s(e.launch[0], peaks.parse_dims(e.launch[1]))
        if b is not None and e.dur_us > 0:
            bound += b
            time += e.dur_us / 1e6
    return 100.0 * bound / time if time else None


def idle_share(r: Readings) -> Optional[float]:
    """The traced window's share of time with nothing running on the device, in %."""
    if r.trace is None or r.trace.wall_us <= 0 or not r.trace.events:
        return None
    return 100.0 * (1.0 - r.trace.busy_us / r.trace.wall_us)


def peak_gib(r: Readings) -> Optional[float]:
    return r.window_peak_bytes / 2**30 if r.window_peak_bytes else None
