"""`utils.device_profile` and `utils.profiling`, the port's counterparts of
the JAX package's ``utils/hlo_profile.py`` and ``utils/profiling.py``, on
the CPU.

* A hand-built Chrome trace in the layout torch.profiler writes on the card:
  the categories (the port's kernels by their csrc symbols, a convolution
  named by the aten op that launched it, products, elementwise, copies), the
  containers (a ``gpu_user_annotation`` mirror, nested aten ops) counted
  once, the FLOPs of an aten op on the one kernel that computes them, the
  port's kernels' work from their ``gadm::`` ranges, and the achieved rates
  `render_table` prints.
* Launch calls whose kernel records the trace lacks, by launching kernel.
* A CPU-only trace: aten ops by self time, so nested ops count once.
* `render_table` gives the JAX `render_table`'s text for the same records.
* `profile_device_ops`, `trace` and `launch_scope` on real CPU traces; the
  backward's units against ``chip_smoke.py``'s ``BWD_UNITS``.

A few seconds of worker time.
"""

import contextlib
import json
import os
import sys

import pytest
import torch

from group_attribution_for_diffusion_models_tpu.utils import hlo_profile as jax_profile
from group_attribution_for_diffusion_models_tpu.utils import profiling as jax_profiling
from group_attribution_for_diffusion_models_tpu_torch.utils import device_profile, profiling

ATTN = "gadm::attention_fwd(B=2,Sq=16,Skv=16,H=1,D=8,dtype=float32)"
GN = "gadm::group_norm_fwd(B=2,C=8,HW=16,G=4,silu=1,dtype=float32,out=float32)"


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _kernel(name, ts, dur, corr=None, ext=None):
    args = {"device": 0, "stream": 7}
    if corr is not None:
        args["correlation"] = corr
    if ext is not None:
        args["External id"] = ext
    return _x("kernel", name, ts, dur, pid=0, tid=7, **args)


NCHW = "void cudnn::engines_precompiled::nchwToNhwcKernel<float>(...)"
FPROP = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"
ATTN_K = "void (anonymous namespace)::attention_fwd_kernel<float, 256>(float const*)"
GN_K = "void (anonymous namespace)::group_norm_fwd_flat<float, float, 4>(...)"
ADD_K = "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float> >(...)"
GEMM_K = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_cublas"
SPLITK = "void cublasLt::splitKreduce_kernel<32, 16, int, float>(...)"
MEMCPY = "Memcpy HtoD (Pageable -> Device)"


def _gpu_trace():
    """Host thread (pid 1) and device stream (pid 0) of one profiled window."""
    return [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        _x("cpu_op", "aten::conv2d", 0, 100, **{"External id": 1, "flops": 2e9}),
        _x("cpu_op", "aten::cudnn_convolution", 10, 80, **{"External id": 2}),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=11),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 5, correlation=12),
        _x("user_annotation", ATTN, 200, 60, **{"External id": 3}),
        _x("cuda_runtime", "cuLaunchKernel", 210, 5, correlation=13),
        _x("user_annotation", GN, 300, 50, **{"External id": 4}),
        _x("cuda_runtime", "cuLaunchKernel", 310, 5, correlation=14),
        _x("cpu_op", "aten::add_", 400, 50, **{"External id": 5}),
        _x("cuda_runtime", "cudaLaunchKernel", 410, 5, correlation=15),
        _x("cpu_op", "aten::addmm", 500, 100, **{"External id": 6, "flops": 1e6}),
        _x("cuda_runtime", "cudaLaunchKernel", 510, 5, correlation=16),
        _kernel(NCHW, 1000, 5, 11),
        _kernel(FPROP, 1010, 20, 12),
        _x("gpu_user_annotation", ATTN, 1035, 12, pid=0, tid=7, **{"External id": 3}),
        _kernel(ATTN_K, 1036, 10, 13),
        _kernel(GN_K, 1050, 4, 14),
        _kernel(ADD_K, 1060, 2, 15),
        _kernel(GEMM_K, 1070, 8, 16),
        # No runtime call of its correlation: linked by External id to the addmm.
        _kernel(SPLITK, 1080, 1, 99, 6),
        _x("gpu_memcpy", MEMCPY, 1090, 3, pid=0, tid=7, correlation=17),
        # Launch calls whose kernels have no event: CUPTI lost their records.
        _x("user_annotation", GN, 700, 30, **{"External id": 7}),
        _x("cuda_runtime", "cuLaunchKernel", 710, 5, correlation=18),
        _x("cpu_op", "aten::mul", 800, 20, **{"External id": 8}),
        _x("cuda_runtime", "cudaLaunchKernel", 805, 5, correlation=19),
        _x("cuda_runtime", "cudaMemcpyAsync", 830, 5, correlation=17),
    ]


def test_gpu_trace_categories_containers_and_work():
    prof = device_profile.summarize(_gpu_trace())
    ops = {r.name: r for r in prof.ops}
    assert {name: r.category for name, r in ops.items()} == {
        NCHW: "convolution", FPROP: "convolution", ATTN_K: "attention_fwd",
        GN_K: "group_norm_fwd", ADD_K: "elementwise", GEMM_K: "gemm", SPLITK: "gemm",
        MEMCPY: "memcpy/memset"}
    # The gpu_user_annotation mirror of the attention range counts nothing.
    assert prof.device_total_us == 5 + 20 + 10 + 4 + 2 + 8 + 1 + 3
    assert prof.by_category["convolution"] == 25 and prof.by_category["gemm"] == 9
    assert prof.launches("attention_fwd") == 1 and prof.launches("group_norm_fwd") == 1
    assert prof.wall_us == 1093
    # An op's FLOPs go to the kernel that computes them, not its layout pass.
    assert ops[FPROP].gflops == 2.0 and ops[NCHW].gflops is None
    assert ops[GEMM_K].gflops == 1e-3 and ops[SPLITK].gflops is None
    assert ops[ATTN_K].gflops == 4 * 2 * 1 * 16 * 16 * 8 / 1e9
    assert ops[ATTN_K].detail == ATTN[len("gadm::attention_fwd("):-1]
    assert ops[GN_K].gbytes == (2 * 8 * 16 * 8 + 2 * 8 * 4 + 2 * 2 * 4 * 4) / 1e9
    assert ops[ADD_K].detail == "aten::add_"
    assert device_profile.untraced_launches(_gpu_trace()) == {"group_norm_fwd": 1,
                                                              "aten::mul": 1}
    table = device_profile.render_table(prof, top=5)
    assert table.splitlines()[0] == "device total: 0.05 ms  (0.05 ms/exec)"
    # The signature (the two kernels of the cudnn_convolution): 2 GFLOP in 25
    # us = 80 TFLOP/s; the fprop kernel alone 100; the GroupNorm's bytes in 4 us.
    assert any("    80.0 TFLOP/s" in ln and "convolution" in ln for ln in table.splitlines())
    assert any("  100.0T" in ln and FPROP in ln for ln in table.splitlines())
    assert f"{ops[GN_K].gbytes / 4 * 1e3:8.1f} TB/s" in table


def test_cpu_trace_counts_each_op_by_its_self_time():
    events = [
        _x("cpu_op", "aten::conv2d", 0, 100, **{"External id": 1, "flops": 3e9}),
        _x("cpu_op", "aten::mkldnn_convolution", 10, 80, **{"External id": 2}),
        _x("cpu_op", "aten::empty", 20, 5, **{"External id": 3}),
        _x("user_annotation", "gadm::attention_fwd(B=1)", 150, 40, **{"External id": 4}),
        _x("cpu_op", "aten::add", 160, 10, **{"External id": 5}),
        _x("cpu_op", "aten::sum", 100, 30, tid=2, **{"External id": 6}),
    ]
    prof = device_profile.summarize(events)
    got = {r.name: (r.total_us, r.category, r.gflops) for r in prof.ops}
    assert got == {
        "aten::conv2d": (20.0, "convolution", None),
        "aten::mkldnn_convolution": (75.0, "convolution", 3.0),
        "aten::empty": (5.0, "convolution", None),
        "aten::add": (10.0, "elementwise", None),
        "aten::sum": (30.0, "reduction", None),
    }
    assert prof.device_total_us == 140.0  # the top-level ops' spans, once


def test_render_table_is_the_jax_table():
    rows = [("fusion.1", "convolution", 120.0, 3, "conv [64]", 1.5, None),
            ("copy.2", "memcpy/memset", 40.0, 2, "", None, 0.004),
            ("k.3", "elementwise", 7.5, 1, "aten::add_", None, None)]
    tables = []
    for mod in (device_profile, jax_profile):
        ops = [mod.OpRecord(name=n, category=c, total_us=us, count=k, detail=d, gflops=gf,
                            gbytes=gb) for n, c, us, k, d, gf, gb in rows]
        prof = mod.ProfileResult(ops=ops, device_total_us=167.5,
                                 by_category={r.category: r.total_us for r in ops})
        tables.append(mod.render_table(prof, top=2, repeats=3))
    # The one difference: the JAX table labels TB/s (GB per us x 1e3) GB/s.
    assert "TB" in tables[0]
    assert tables[0] == tables[1].replace(" GB/s   ", " TB/s   ").replace("GB  ", "TB  ")


def test_profile_device_ops_and_trace_on_the_cpu(tmp_path):
    conv = torch.nn.Conv2d(4, 8, 3, padding=1)
    x = torch.randn(2, 4, 8, 8)
    prof = device_profile.profile_device_ops(lambda: conv(x), repeats=2)
    rated = [r for r in prof.ops if r.gflops]
    assert rated and all(r.category == "convolution" for r in rated)
    assert sum(r.count for r in rated) == 2
    assert rated[0].gflops == 2 * 2 * 8 * 8 * 8 * 4 * 9 / 1e9
    assert 0 < prof.device_total_us <= prof.wall_us

    with profiling.trace(None):
        conv(x)  # no profiler, no file
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.launch_scope("attention_fwd", lambda: dict(B=1, D=8)):
            conv(x)
        with profiling.annotate("step"):
            conv(x)
    (path,) = device_profile.trace_files(str(tmp_path))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gadm::attention_fwd(B=1,D=8)", "step"} <= names
    # Outside a profile a launch opens no range.
    def dims():
        raise AssertionError("an unprofiled launch builds no range")

    assert isinstance(profiling.launch_scope("attention_fwd", dims), contextlib.nullcontext)


def test_launch_work_counts_as_chip_smoke_bounds():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    dims = dict(B=64, Sq=256, Skv=256, H=1, D=256, dtype="float32")
    unit = 64 * 256 * 256 * 256
    dq = device_profile.launch_work("attention_bwd_dq", dims)[0]
    dkv = device_profile.launch_work("attention_bwd_dkv", dims)[0]
    assert (dq + dkv) * 1e9 == pytest.approx(chip_smoke.BWD_UNITS * unit, rel=1e-12)
    assert device_profile.launch_work("attention_fwd", dims)[0] * 1e9 == pytest.approx(
        4 * unit, rel=1e-12)
    assert device_profile.launch_work("jl_projection", dict(B=2, D=10, P=4, dtype="float32")) \
        == (2 * 2 * 10 * 4 / 1e9, None)


def test_timings_as_the_jax_timings():
    got, want = profiling.Timings(), jax_profiling.Timings()
    for t in (got, want):
        with t.section("train"):
            pass
        with t.section("train"):
            pass
    assert got.as_dict("x_").keys() == want.as_dict("x_").keys() == {"x_train_time"}


@pytest.mark.parametrize("name,category", [
    ("void (anonymous namespace)::attention_bwd_dq_kernel<float, 256>(...)", "attention_bwd_dq"),
    ("void (anonymous namespace)::attention_bwd_dkv_kernel<float, 64>(...)",
     "attention_bwd_dkv"),
    ("void (anonymous namespace)::group_norm_bwd_stream<float, 4>(...)", "group_norm_bwd"),
    ("void (anonymous namespace)::group_norm_fwd_stream<float, float, 4>(...)",
     "group_norm_fwd"),
    ("void (anonymous namespace)::jl_partial_kernel<__nv_bfloat16>(...)", "jl_projection"),
    ("jl_reduce_kernel(float const*, float*, int, long, float)", "jl_projection_reduce"),
    ("void cudnn::winograd_nonfused::winogradWgradData4x4<float, float>(...)", "convolution"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(...)", "reduction"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>(...)",
     "elementwise"),
    ("void gemmSN_TN_kernel<float, 128, 16, 2, 4, 8, 9, false>(...)", "gemm"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_names_by_category(name, category):
    prof = device_profile.summarize([_kernel(name, 0, 1)])
    assert [r.category for r in prof.ops] == [category]
