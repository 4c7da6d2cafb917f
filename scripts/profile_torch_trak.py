#!/usr/bin/env python3
"""Where the time of the port's TRAK features goes, on one GPU.

Computes projected per-sample gradient features of the full-width CIFAR
UNet2D (random init from a seed, float32, TF32 off) for a batch of 32
seeded images in [-1, 1], 10 timesteps projected to 4096, through
`attributions.methods.trak.make_grad_feature_fn`, the function
`cli.grad_features` runs, in each grad mode (full, attn_full, probe):

1. unprofiled: 1 warm-up batch, then 3 timed ones (host clock): seconds
   per batch and examples/s, and how each timed batch splits between the
   timestep-mean per-sample gradients (`mean_gradients`) and the JL
   projection, each part ended by a device synchronise (a batch is the sum
   of its two parts);
2. profiled: 1 batch under torch.profiler, tracing device activity only:
   device time by kernel group and the device's idle share;

and, for comparison, the same full per-sample gradients of one batch from
one autograd call per example and timestep (batch 1), the way there is
without vmap rules.

Run from the repository root:

    python3 scripts/profile_torch_trak.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_torch_sampling import group  # noqa: E402

BATCH, TIMESTEPS, PROJ_DIM = 32, 10, 4096
WARM, TIMED = 1, 3


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from group_attribution_for_diffusion_models_tpu_torch.attributions.methods.trak import (
        make_grad_feature_fn)
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
    from group_attribution_for_diffusion_models_tpu_torch.models.lora import (
        attention_params_filter, probe_sketch_init)
    from group_attribution_for_diffusion_models_tpu_torch.ops import jl_project

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("cifar")
    model = build_unet(cfg.unet, seed=0).to(dev).eval()
    schedule = make_schedule(cfg.scheduler, dev)
    images = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (BATCH, 3, 32, 32)).astype(np.float32)).to(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}; CIFAR UNet2D f32, batch {BATCH} x "
          f"{TIMESTEPS} timesteps, projected to {PROJ_DIM}")

    modes = {
        "full": {},
        "attn_full": {"params_filter": attention_params_filter(model)},
        "probe": {"sketch_probe": probe_sketch_init(
            model, k=64, generator=torch.Generator().manual_seed(0))},
    }
    for mode, kw in modes.items():
        fn = make_grad_feature_fn(model, schedule, cfg.scheduler, proj_dim=PROJ_DIM,
                                  num_timesteps=TIMESTEPS, **kw)

        def batch(seed: int):
            """(gradient seconds, JL seconds) of one batch: what `fn` does,
            with a device synchronise between its two parts."""
            gen = torch.Generator(device=dev).manual_seed(seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flat = fn.mean_gradients(images, generator=gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            jl_project(flat, PROJ_DIM)
            torch.cuda.synchronize()
            return t1 - t0, time.perf_counter() - t1

        for i in range(WARM):
            batch(i)
        torch.cuda.reset_peak_memory_stats()
        parts = [batch(WARM + i) for i in range(TIMED)]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        secs = [g + j for g, j in parts]
        grads_s = sum(g for g, _ in parts) / TIMED
        jl_s = sum(j for _, j in parts) / TIMED

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall_ms = sum(batch(10)) * 1e3
        by_group = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                g = by_group.setdefault(group(ev.key), [0.0, 0])
                g[0] += dev_us / 1e3
                g[1] += ev.count
        busy = sum(ms for ms, _ in by_group.values())
        if busy <= 0:
            raise SystemExit("the profiler recorded no device time")
        mean_s = sum(secs) / len(secs)
        print(f"[{mode}] {fn.dim} gradient coordinates: unprofiled {TIMED} batches "
              f"{', '.join(f'{s:.4f}' for s in secs)} s (mean {mean_s:.4f} s/batch, "
              f"{BATCH / mean_s:.2f} examples/s), peak {peak_gib:.2f} GiB; split, mean of the "
              f"{TIMED}: per-sample gradients {grads_s:.4f} s ({grads_s / TIMESTEPS * 1e3:.2f} "
              f"ms a timestep), JL projection {jl_s * 1e3:.2f} ms "
              f"({100 * jl_s / mean_s:.1f}%)")
        print(f"[{mode}] profiled batch: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
              f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
        for g, (ms, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
            print(f"  {g:34s} {ms:9.3f} ms {100 * ms / busy:5.1f}%  launches {n}")

    # Without vmap rules: one batch-1 forward and backward per example and
    # timestep, each gradient added into a (B, D) buffer.
    from group_attribution_for_diffusion_models_tpu_torch.attributions.methods.trak import (
        feature_timesteps)
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import add_noise

    params = list(model.parameters())
    acc = torch.zeros((BATCH, sum(p.numel() for p in params)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in feature_timesteps(cfg.scheduler.num_train_timesteps, TIMESTEPS):
        noise = torch.randn(images.shape, generator=gen, device=dev)
        t_b = torch.full((1,), int(t), device=dev)
        for b in range(BATCH):
            x_t = add_noise(schedule, images[b:b + 1], noise[b:b + 1], t_b)
            eps = model(x_t, t_b)
            grads = torch.autograd.grad(torch.mean((eps - noise[b:b + 1]) ** 2), params)
            acc[b] += torch.cat([g.reshape(-1) for g in grads])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    print(f"[loop] full per-sample gradients of one batch, one autograd call per example "
          f"and timestep: {loop_s:.4f} s ({loop_s / (BATCH * TIMESTEPS) * 1e3:.2f} ms a call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
