"""The per-layer readers on a small hand-made Chrome trace: the idle union,
the categories, the roofline arithmetic, the idle gaps' names."""

import math

import pytest

import tiny  # noqa: F401  (puts the benchmark's directory on the path)
from benchlib import peaks, readers
from benchlib.trace import summarize

ATTN_DIMS = "B=64,Sq=256,Skv=256,H=1,D=256,dtype=float32"
GN_DIMS = "B=64,C=128,HW=1024,G=32,silu=1,dtype=float32,out=float32"


def _host(name, ts, dur, cat="cpu_op", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "pid": 1, "tid": 1, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def canned():
    """A 100 us window: a convolution 10-30, an attention forward 25-45
    (overlapping), a GroupNorm 60-70, a copy 80-85; idle 0-10, 45-60, 70-80
    and 85-100, the host in a sync range during 45-60."""
    return [
        _host("bench::traced", 0, 100, cat="user_annotation"),
        _host("aten::convolution", 2, 5),
        _launch(3, 1),
        _kernel("sm90_xmma_fprop_implicit_gemm_f32", 10, 20, 1),
        _host(f"gadm::attention_fwd({ATTN_DIMS})", 8, 4, cat="user_annotation"),
        _launch(9, 2),
        _kernel("void attention_fwd_kernel<256>(...)", 25, 20, 2),
        _host("cudaDeviceSynchronize", 44, 16, cat="cuda_runtime"),
        _host(f"gadm::group_norm_fwd({GN_DIMS})", 30, 3, cat="user_annotation"),
        _launch(31, 3),
        _kernel("group_norm_fwd_flat", 60, 10, 3),
        _launch(34, 4),
        _kernel("Memcpy DtoD", 80, 5, 4, cat="gpu_memcpy"),
        _launch(36, 5),  # its kernel's record is missing
        _kernel("outside the window", 150, 10, 6),
    ]


def test_summary_union_categories_and_gaps():
    s = summarize(canned())
    assert s.wall_us == 100
    assert s.busy_us == pytest.approx(20 + 15 + 10 + 5)  # 10-45, 60-70, 80-85
    cats = {e.name: e.category for e in s.events}
    assert cats["sm90_xmma_fprop_implicit_gemm_f32"] == "convolution"
    assert cats["void attention_fwd_kernel<256>(...)"] == "attention_fwd"
    assert cats["group_norm_fwd_flat"] == "group_norm_fwd"
    assert cats["Memcpy DtoD"] == "memcpy/memset"
    assert "outside the window" not in cats
    gaps = dict(s.top_gaps())
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(15e-6)
    assert sum(gaps.values()) == pytest.approx(50e-6)
    assert s.untraced == {"?": 1}
    assert s.top_ops(1)[0][0] in ("sm90_xmma_fprop_implicit_gemm_f32",
                                  "void attention_fwd_kernel<256>(...)")


def test_readers_on_the_canned_trace():
    s = summarize(canned())
    r = readers.Readings(units=10, wall_s=2.0, spans=[(0.01, 2), (0.03, 2)],
                         flops_per_unit=33e12, window_peak_bytes=3 * 2**30, trace=s,
                         traced_units=2)
    assert readers.idle_share(r) == pytest.approx(50.0)
    assert readers.category_ms_per_unit(r, "convolution") == pytest.approx(0.020 / 2)
    assert readers.host_ms_per_unit(r) == pytest.approx(10.0)
    assert readers.mfu(r) == pytest.approx(100 * 33e12 * 10 / 2.0 / 165e12)
    assert readers.peak_gib(r) == pytest.approx(3.0)
    attn = peaks.launch_bound_s("attention_fwd", peaks.parse_dims(ATTN_DIMS))
    assert readers.roofline(r, ("attention_fwd",)) == pytest.approx(100 * attn / 20e-6)
    gn = peaks.launch_bound_s("group_norm_fwd", peaks.parse_dims(GN_DIMS))
    assert readers.roofline(r, ("group_norm_fwd", "group_norm_bwd")) == \
        pytest.approx(100 * gn / 10e-6)
    assert readers.roofline(r, ("attention_bwd_dq",)) is None  # nothing to read


def test_bounds_match_the_kernel_table():
    """B1 and B2 at the CIFAR shape bound by operations at 495/3 TFLOP/s, B3
    and B4 by bytes: PERF.md's kernel table (0.0260, 0.0390, 0.0521, 0.0200,
    0.0301 ms)."""
    d = peaks.parse_dims(ATTN_DIMS)
    assert 1e3 * peaks.launch_bound_s("attention_fwd", d) == pytest.approx(0.0260, abs=1e-4)
    assert 1e3 * peaks.launch_bound_s("attention_bwd_dq", d) == pytest.approx(0.0390, abs=1e-4)
    assert 1e3 * peaks.launch_bound_s("attention_bwd_dkv", d) == pytest.approx(0.0521, abs=1e-4)
    g = peaks.parse_dims(GN_DIMS)
    assert 1e3 * peaks.launch_bound_s("group_norm_fwd", g) == pytest.approx(0.0200, abs=1e-4)
    assert 1e3 * peaks.launch_bound_s("group_norm_bwd", g) == pytest.approx(0.0301, abs=1e-4)


def test_readers_without_a_trace_return_nothing():
    r = readers.Readings(units=0, wall_s=1.0)
    for fn in (readers.idle_share, readers.mfu, readers.host_ms_per_unit, readers.peak_gib):
        assert fn(r) is None
    assert readers.roofline(r, ("attention_fwd",)) is None
    assert not math.isnan(peaks.F32_TENSOR_FLOPS)
