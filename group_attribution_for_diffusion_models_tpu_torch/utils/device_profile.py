"""Per-kernel device profiling through torch.profiler.

The counterpart of the JAX package's ``utils/hlo_profile.py``. That module
joins the device events of a ``jax.profiler`` trace with the executable's
HLO text, so that each nanosecond lands on an HLO instruction; torch has no
HLO, so this one keeps the JAX module's data model (`OpRecord`,
`ProfileResult`) and its table (`render_table`: the device total, "by
category", "by signature", "top ops"), and reads a Chrome trace of
`utils.profiling.trace` instead:

* **Device time** is the trace's kernel events (``cat`` ``kernel``) and its
  copies and fills (``gpu_memcpy``, ``gpu_memset``). A trace with none (a
  run on the CPU) takes the aten ops that call no other op, so the same code
  runs in the CPU tests, each op by its self time (its span less its child
  ops'). Ranges that hold other events (a ``record_function`` range, its
  ``gpu_user_annotation`` mirror, the span of an aten op that calls
  others) are containers and count nothing, as the JAX module drops while
  loops.
* **The launching op** of a kernel is the chain of host ranges (aten ops and
  ``record_function`` ranges) open on the thread at the runtime call whose
  ``correlation`` the kernel carries; failing that, the host event with the
  kernel's ``External id``.
* **Categories**: the port's own kernels by their symbols in ``csrc/*.cu``,
  under the names `ops.launch_counts` gives them (B1 ``attention_fwd``, B2
  ``attention_bwd_dq`` and ``attention_bwd_dkv``, B3 ``group_norm_fwd``, B4
  ``group_norm_bwd``, B5 ``jl_projection`` and its ``jl_projection_reduce``
  pass); then ``convolution`` (a kernel an aten convolution launched, or a
  cuDNN / implicit-GEMM / xmma name), ``gemm`` (an aten product, or a cuBLAS
  / CUTLASS name), ``elementwise``, ``reduction``, ``memcpy/memset`` and
  ``other``.
* **Work**: a convolution or product kernel gets the FLOPs that
  ``with_flops`` puts on its aten op (`utils.profiling.trace` writes them
  into the trace): the longest of the op's kernels whose own name is a
  convolution or product takes them all. The port's kernels get theirs from the
  shape their wrapper names in its ``gadm::<kernel>(...)`` range
  (`utils.profiling.launch_scope`), counted as ``chip_smoke.py`` counts them:
  B1 the two products, 4·B·H·Sq·Skv·D FLOPs; the backward's 18 units of
  B·H·Sq·Skv·D (``BWD_UNITS``), 10 in the dQ pass (S, P·V, S, dP, dS·K)
  and 8 in the dK/dV pass (S, dP, dV, dK); B5 2·B·D·P; and B3 and B4,
  which are bound by bytes, the bytes of their bound instead.

Usage:
    with utils.profiling.trace(logdir, device): ...
    print(render_table(parse_trace_dir(logdir)))
or ``prof = profile_device_ops(run, repeats)``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from .profiling import trace

# Symbol of a kernel in csrc/*.cu -> its category: the ops.KERNELS key.
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
_SYMBOL_RE = re.compile(r"\b(" + "|".join(KERNEL_SYMBOLS) + r")\b")
_LAUNCH_RE = re.compile(r"^gadm::(\w+)\((.*)\)$")
# Category of another kernel (or, on the CPU, an aten op) by its name, first
# match; an aten convolution or product above a kernel decides first.
_CONV_OP = re.compile(r"^aten::(conv|_conv|cudnn_conv|mkldnn_conv|slow_conv|thnn_conv)")
_GEMM_OP = re.compile(r"^aten::(mm|addmm|bmm|baddbmm|matmul|linear|addmv|mv|dot|_addmm)")
_NAME_RULES = (
    ("convolution", re.compile(
        r"conv|cudnn|implicit_gemm|implicit_convolve|xmma_(fprop|dgrad|wgrad)|dgrad|wgrad"
        r"|winograd")),
    ("gemm", re.compile(r"gemm|gemv|cublas|cutlass|" + _GEMM_OP.pattern[1:] + r"\b")),
    ("memcpy/memset", re.compile(r"^aten::(copy_|fill_|zero_)$")),
    ("reduction", re.compile(
        r"reduce|Reduce|reduction|softmax|norm(?!al)|"
        r"^aten::(sum|mean|var|std|amax|amin|max|min|argmax|argmin|cumsum|prod|all|any)\b")),
    ("elementwise", re.compile(
        r"elementwise|Elementwise|foreach|multi_tensor|CatArray|index|gather|scatter"
        r"|^aten::")),
)
_DEVICE_CATS = {"kernel": None, "gpu_memcpy": "memcpy/memset", "gpu_memset": "memcpy/memset"}
_HOST_CATS = ("cpu_op", "user_annotation")
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclass
class OpRecord:
    name: str            # kernel name (aten op name on the CPU)
    category: str        # one of the categories of the module docstring
    total_us: float = 0.0
    count: int = 0
    detail: str = ""     # the launching op and its input shapes, or a launch's shape
    gflops: Optional[float] = None  # per execution, where the trace gives it
    gbytes: Optional[float] = None  # per execution, the port's bytes-bound kernels


@dataclass
class ProfileResult:
    ops: list = field(default_factory=list)          # [OpRecord], sorted desc
    device_total_us: float = 0.0
    wall_us: float = 0.0
    by_category: dict = field(default_factory=dict)  # category -> us

    def launches(self, category: str) -> int:
        """Device events of `category` (a kernel's launches for the port's own)."""
        return sum(r.count for r in self.ops if r.category == category)


def launch_work(kernel: str, dims: Dict[str, object]):
    """(gflops, gbytes) of one launch of the port's `kernel` at `dims` (the
    fields of its ``gadm::`` range), as the module docstring counts them."""
    if kernel.startswith("attention"):
        unit = dims["B"] * dims["H"] * dims["Sq"] * dims["Skv"] * dims["D"]
        per = {"attention_fwd": 4, "attention_bwd_dq": 10, "attention_bwd_dkv": 8}[kernel]
        return per * unit / 1e9, None
    if kernel == "jl_projection":
        return 2.0 * dims["B"] * dims["D"] * dims["P"] / 1e9, None
    if kernel.startswith("group_norm"):
        n = dims["B"] * dims["C"] * dims["HW"]
        es = _DTYPE_BYTES[dims["dtype"]]
        stats = 2 * dims["B"] * dims["G"] * 4
        if kernel == "group_norm_fwd":
            nbytes = n * (es + _DTYPE_BYTES[dims.get("out", dims["dtype"])]) \
                + 2 * dims["C"] * 4 + stats
        else:
            nbytes = 3 * n * es + 4 * dims["C"] * 4 + stats
        return None, nbytes / 1e9
    return None, None


def _parse_dims(args: str) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for part in filter(None, args.split(",")):
        key, _, value = part.partition("=")
        out[key] = int(value) if value.lstrip("-").isdigit() else value
    return out


def _category(name: str) -> str:
    for cat, rule in _NAME_RULES:
        if rule.search(name):
            return cat
    return "other"


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e.get("dur", 0.0))


def _host_chains(events: List[dict]):
    """Sweep each thread's host ranges (aten ops and record_function ranges)
    in time order. Returns (the chain of every host event: the ranges that
    hold it, outermost first; every cpu_op's self time, its span less its
    child ops'; a function giving the ranges open on a thread at a time)."""
    by_tid: Dict[tuple, list] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _HOST_CATS:
            by_tid[(e.get("pid"), e.get("tid"))].append(e)
    chains: Dict[int, list] = {}
    self_us: Dict[int, tuple] = {}  # id -> (event, self time)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack: List[dict] = []
        for e in evs:
            while stack and _end(stack[-1]) <= float(e["ts"]):
                stack.pop()
            chains[id(e)] = list(stack)
            if e.get("cat") == "cpu_op":
                self_us[id(e)] = (e, float(e.get("dur", 0.0)))
                parent = next((s for s in reversed(stack) if s.get("cat") == "cpu_op"), None)
                if parent is not None:
                    op, us = self_us[id(parent)]
                    self_us[id(parent)] = (op, us - float(e.get("dur", 0.0)))
            stack.append(e)

    def open_at(key: tuple, ts: float) -> list:
        """Host ranges of thread `key` open at `ts`, outermost first: the
        last range to start at or before `ts`, and its chain, less those
        that ended before `ts` (ranges on a thread nest)."""
        evs = by_tid.get(key, [])
        lo, hi = 0, len(evs)
        while lo < hi:
            mid = (lo + hi) // 2
            if float(evs[mid]["ts"]) <= ts:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0:
            return []
        last = evs[lo - 1]
        return [r for r in chains[id(last)] + [last] if _end(r) >= ts]

    return chains, list(self_us.values()), open_at


def _attribute(device: List[tuple]) -> List[OpRecord]:
    """OpRecords, aggregated by (name, category, detail, work), from
    (event, microseconds, chain of host ranges above it outermost first,
    category or None) entries."""
    rows = []
    flops_users: Dict[int, list] = defaultdict(list)  # id(op with flops) -> its rows
    for e, us, chain, cat in device:
        name = e.get("name", "")
        detail, gflops, gbytes = "", None, None
        sym = _SYMBOL_RE.search(name)
        if sym:
            cat = KERNEL_SYMBOLS[sym.group(1)]
            launch = next((m for r in reversed(chain) if (m := _LAUNCH_RE.match(r["name"]))),
                          None)
            if launch and launch.group(1) == cat:
                detail = launch.group(2)
                gflops, gbytes = launch_work(cat, _parse_dims(detail))
        elif cat is None:
            ops = [r["name"] for r in [*chain, e] if r.get("cat") == "cpu_op"]
            if any(_CONV_OP.match(o) for o in ops):
                cat = "convolution"
            elif any(_GEMM_OP.match(o) for o in ops):
                cat = "gemm"
            else:
                cat = _category(name)
        if not detail:
            # The innermost aten op at the launch; on the CPU the op itself.
            op = next((r for r in reversed([*chain, e]) if r.get("cat") == "cpu_op"), None)
            if op is not None:
                dims = (op.get("args") or {}).get("Input Dims")
                shapes = f"{[d for d in dims if d]}" if dims else ""
                detail = shapes if op is e else f"{op['name']} {shapes}".rstrip()
        row = [name, us, cat, detail, gflops, gbytes]
        rows.append(row)
        if not sym and cat in ("convolution", "gemm"):
            owner = next((r for r in reversed([*chain, e])
                          if "flops" in (r.get("args") or {})), None)
            if owner is not None:
                flops_users[id(owner)].append((row, owner))
    # An op's FLOPs go to the one row under it that computes them: the
    # longest whose own name is a convolution or product, else the longest.
    for users in flops_users.values():
        named = [u for u in users if _category(u[0][0]) in ("convolution", "gemm")]
        row, owner = max(named or users, key=lambda u: u[0][1])
        row[4] = float(owner["args"]["flops"]) / 1e9
    agg: Dict[tuple, OpRecord] = {}
    for name, us, cat, detail, gflops, gbytes in rows:
        rec = agg.get((name, cat, detail, gflops))
        if rec is None:
            rec = agg[(name, cat, detail, gflops)] = OpRecord(
                name=name, category=cat, detail=detail, gflops=gflops, gbytes=gbytes)
        rec.total_us += us
        rec.count += 1
    return sorted(agg.values(), key=lambda r: -r.total_us)


def summarize(trace_events: List[dict]) -> ProfileResult:
    """A ProfileResult from the events of one Chrome trace (module
    docstring); `wall_us` is the span of the trace's events."""
    chains, self_times, open_at = _host_chains(trace_events)
    runtime = {(e.get("args") or {}).get("correlation"): e for e in trace_events
               if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")}
    by_external = {(e.get("args") or {}).get("External id"): e for e in trace_events
                   if e.get("ph") == "X" and e.get("cat") in _HOST_CATS}
    device = []
    for e in trace_events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        args = e.get("args") or {}
        call = runtime.get(args.get("correlation"))
        if call is not None:
            chain = open_at((call.get("pid"), call.get("tid")), float(call["ts"]))
        elif (host := by_external.get(args.get("External id"))) is not None:
            chain = chains[id(host)] + [host]
        else:
            chain = []
        device.append((e, float(e.get("dur", 0.0)), chain, _DEVICE_CATS[e["cat"]]))
    if not device:  # a CPU run: each aten op's self time
        device = [(e, us, chains[id(e)], None) for e, us in self_times]
    ops = _attribute(device)
    by_cat: Dict[str, float] = defaultdict(float)
    for r in ops:
        by_cat[r.category] += r.total_us
    spans = [(float(e["ts"]), _end(e)) for e in trace_events
             if e.get("ph") == "X" and "ts" in e]
    wall = max(b for _, b in spans) - min(a for a, _ in spans) if spans else 0.0
    return ProfileResult(ops=ops, device_total_us=sum(r.total_us for r in ops), wall_us=wall,
                         by_category=dict(by_cat))


def trace_files(trace_dir: str) -> List[str]:
    """The Chrome traces `utils.profiling.trace` (or TensorBoard's handler)
    wrote into `trace_dir`, oldest first."""
    files = (glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
             + glob.glob(os.path.join(trace_dir, "*.pt.trace.json.gz")))
    return sorted(files, key=os.path.getmtime)


def load_trace(trace_dir: str) -> List[dict]:
    """The events of the newest trace in `trace_dir`."""
    files = trace_files(trace_dir)
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json under {trace_dir}")
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        return json.load(f).get("traceEvents", [])


def parse_trace_dir(trace_dir: str) -> ProfileResult:
    """The newest trace in `trace_dir`, summarized (`summarize`)."""
    return summarize(load_trace(trace_dir))


def untraced_launches(trace_events: List[dict]) -> Dict[str, int]:
    """Kernel launch calls of the host whose kernel has no event in the
    trace (CUPTI lost its record), counted by what launched them: the port's
    kernel of the ``gadm::`` range the call ran in, else the innermost aten
    op, else "?"."""
    _, _, open_at = _host_chains(trace_events)
    traced = {(e.get("args") or {}).get("correlation") for e in trace_events
              if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS}
    out: Dict[str, int] = defaultdict(int)
    for e in trace_events:
        if (e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime", "cuda_driver")
                or "Launch" not in e.get("name", "")
                or (e.get("args") or {}).get("correlation") in traced):
            continue
        chain = open_at((e.get("pid"), e.get("tid")), float(e["ts"]))
        launch = next((m for r in reversed(chain) if (m := _LAUNCH_RE.match(r["name"]))), None)
        op = next((r["name"] for r in reversed(chain) if r.get("cat") == "cpu_op"), "?")
        out[launch.group(1) if launch else op] += 1
    return dict(out)


def profile_device_ops(run: Callable[[], None], repeats: int = 1) -> ProfileResult:
    """Trace `repeats` calls of `run()` (with CUDA activity where there is a
    card) and attribute the device time; repeated launches of one kernel at
    one shape aggregate into one OpRecord."""
    with tempfile.TemporaryDirectory(prefix="torchprof_") as d:
        with trace(d):
            for _ in range(repeats):
                run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        return parse_trace_dir(d)


def render_table(prof: ProfileResult, top: int = 30,
                 repeats: int = 1) -> str:
    """Human-readable per-op table with achieved TFLOP/s where derivable,
    else TB/s: the JAX table's text, but for that unit, which the JAX table
    prints as GB/s for the same number (GB/µs × 1e3 is TB/s)."""
    lines = []
    t = prof.device_total_us
    lines.append(f"device total: {t/1e3:.2f} ms  ({t/1e3/max(repeats,1):.2f} ms/exec)")
    lines.append("-- by category --")
    for cat, us in sorted(prof.by_category.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {cat:<22} {us/1e3:9.2f} ms  {100*us/t:5.1f}%")
    # Signature rollup: all records sharing (category, detail) as one line,
    # with the aggregate achieved rate: the per-op-class efficiency view.
    sig: dict = {}
    for r in prof.ops:
        key = (r.category, r.detail)
        us, gf, gb, n = sig.get(key, (0.0, 0.0, 0.0, 0))
        sig[key] = (us + r.total_us,
                    gf + (r.gflops or 0.0) * r.count,
                    gb + (r.gbytes or 0.0) * r.count, n + 1)
    lines.append("-- by signature --")
    for (cat, det), (us, gf, gb, n) in sorted(sig.items(), key=lambda kv: -kv[1][0]):
        # gf [GFLOP] / us [µs] = PFLOP/s; ×1e3 → TFLOP/s. Same for TB/s.
        if gf and us:
            rate = f"{gf / us * 1e3:8.1f} TFLOP/s"
        elif gb and us:
            rate = f"{gb / us * 1e3:8.1f} TB/s   "
        else:
            rate = " " * 16
        lines.append(
            f"  {us/1e3:9.2f} ms {100*us/t:5.1f}% {rate}"
            f"  {n:4d} insts  {cat} {det}"
        )
    lines.append(f"-- top {top} ops --")
    lines.append(f"  {'us_total':>10} {'n':>5} {'%':>5} {'rate':>8}  name / detail")
    for r in prof.ops[:top]:
        if r.gflops and r.total_us:
            # gflops is per-execution; total_us spans r.count executions.
            rate = f"{r.gflops * r.count / r.total_us * 1e3:7.1f}T"
        elif r.gbytes and r.total_us:
            rate = f"{r.gbytes * r.count / r.total_us * 1e3:6.1f}TB"
        else:
            rate = " " * 8
        lines.append(
            f"  {r.total_us:10.1f} {r.count:5d} {100*r.total_us/t:5.1f} {rate}"
            f"  {r.name}  [{r.category}] {r.detail}"
        )
    return "\n".join(lines)
