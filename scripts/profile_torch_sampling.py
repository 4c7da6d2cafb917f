#!/usr/bin/env python3
"""Where the time of the port's CIFAR sampling step goes, on one GPU.

Samples the full-width CIFAR UNet2D (random weights from a seed) at batch
64 in two ways:

1. unprofiled: ``cli.generate_samples`` writes 2 batches x 100 DDIM steps
   from a checkpoint of that model; the second (warm) batch gives s/batch
   and ms/step;
2. profiled: 10 DDIM steps through the port's sampler under torch.profiler,
   tracing device activity only (no host-side op events, which would slow
   the host), giving device time by kernel, grouped into the port's
   attention and GroupNorm kernels, convolutions, GEMMs and the rest.

The device's idle share is printed against both wall times: the profiled
one, and the unprofiled ms/step. Run from the repository root:

    python3 scripts/profile_torch_sampling.py --dtype fp32
    python3 scripts/profile_torch_sampling.py --dtype bf16
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH, TIMED_STEPS, TIMED_BATCHES, PROFILED_STEPS = 64, 100, 2, 10


def group(name: str) -> str:
    """The kernel group of a device kernel's name (also read by
    profile_torch_training.py and profile_torch_trak.py)."""
    low = name.lower()
    for kernel in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv",
                   "group_norm_fwd", "group_norm_bwd"):
        if f"{kernel}_" in name:  # <kernel>_kernel; GroupNorm's _flat and _stream
            return f"{kernel} (port kernel)"
    if "jl_partial_kernel" in name or "jl_reduce_kernel" in name:
        return "jl_projection (port kernel)"
    if "multi_tensor_apply" in low:
        return "optimizer/EMA (foreach)"
    # cuDNN's convolutions: implicit GEMMs, and FFT ones (fft2d, the complex
    # pointwise product and complex GEMM between them, filter flips), with
    # their data- and weight-gradient kernels.
    if any(s in low for s in ("conv", "implicit", "fprop", "dgrad", "wgrad", "winograd",
                              "fft", "complex", "cf32", "flip_filter")):
        return "convolution (cuDNN)"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout change (cuDNN)"
    if "gemm" in low:
        return "gemm (linear layers)"
    if "elementwise" in low or "catarray" in low or "reduce" in low:
        return "elementwise/cat/reduce (PyTorch)"
    return "other"


def device_activity(prof) -> dict:
    """The kernels, copies and fills of a torch.profiler trace, from the
    trace's own intervals: "busy_ms", the union of their intervals (the time
    the device was busy); "summed_ms", the sum of their durations, which
    exceeds the union where streams overlap; "streams", ms by stream;
    "by_kernel", name -> [ms, launches] (also read by
    profile_torch_training.py and chip_smoke.py)."""
    import json

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"), e["name"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end, streams, by_kernel = 0.0, float("-inf"), {}, {}
    for start, stop, stream, name in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
        streams[stream] = streams.get(stream, 0.0) + (stop - start) / 1e3
        entry = by_kernel.setdefault(name, [0.0, 0])
        entry[0] += (stop - start) / 1e3
        entry[1] += 1
    return {"busy_ms": busy / 1e3, "summed_ms": sum(streams.values()), "streams": streams,
            "by_kernel": by_kernel}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from group_attribution_for_diffusion_models_tpu_torch.cli import generate_samples
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_sampler
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
    from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config("cifar")
    model = build_unet(cfg.unet, seed=0).eval()
    with tempfile.TemporaryDirectory(prefix="profile_sampling_") as tmp:
        sd = model.state_dict()
        save_checkpoint(os.path.join(tmp, "model"), 0, sd, sd, unet_spec=cfg.unet)
        secs = generate_samples.main([
            "--dataset", "cifar", "--load", os.path.join(tmp, "model"),
            "--sample_outdir", os.path.join(tmp, "samples"), "--dtype", args.dtype,
            "--n_samples", str(BATCH * TIMED_BATCHES), "--batch_size", str(BATCH),
            "--num_inference_steps", str(TIMED_STEPS),
        ])["batch_seconds"]
    step_ms = secs[TIMED_BATCHES - 1] / TIMED_STEPS * 1e3

    model.to(device=dev, dtype=dtype)
    sampler = make_sampler(model, cfg.scheduler, (BATCH, 3, 32, 32), device=dev,
                           num_inference_steps=PROFILED_STEPS)
    gen = torch.Generator(device=dev)
    sampler(generator=gen.manual_seed(0))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler(generator=gen.manual_seed(1))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.key] = (dev_us / 1e3, ev.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    if busy <= 0:
        raise SystemExit("the profiler recorded no device time")
    groups = {}
    for name, (ms, n) in by_kernel.items():
        g = groups.setdefault(group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    busy_step = busy / PROFILED_STEPS
    print(f"{card}; torch {torch.__version__}; CIFAR UNet2D {args.dtype}, batch {BATCH}")
    print(f"unprofiled generate_samples, {TIMED_BATCHES} batches x {TIMED_STEPS} DDIM steps: "
          f"s/batch {', '.join(f'{s:.3f}' for s in secs.values())}; last batch "
          f"{step_ms:.2f} ms/step, idle share {max(0.0, 1 - busy_step / step_ms):.3f} "
          f"(against the profiled device busy time)")
    print(f"profiled, {PROFILED_STEPS} DDIM steps: wall {wall_ms:.2f} ms "
          f"({wall_ms / PROFILED_STEPS:.2f} ms/step), device busy {busy:.2f} ms "
          f"({busy_step:.2f} ms/step), idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:26s} {ms:9.3f} ms {100 * ms / busy:5.1f}%  launches {n}")
    print("top kernels:")
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:9.3f} ms x{n:5d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
