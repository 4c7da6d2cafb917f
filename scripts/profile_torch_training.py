#!/usr/bin/env python3
"""Where the time of the port's CIFAR ensemble train step goes, on one GPU.

Trains 8 full-width CIFAR UNet2D members (random init from a seed, float32
parameters, TF32 off; f32 compute, or bf16 with ``--bf16`` as
``train_ensemble --bf16``) at batch 64 through
`parallel.ensemble.EnsembleTrainer`, the loop
`cli.train_ensemble` runs, on seeded uint8 images of CIFAR-10's size
(50,000 x 32 x 32 x 3) with shapley removal subsets:

1. unprofiled: 3 warm-up ensemble steps, then 10 timed ones (host clock,
   synchronised), with cuDNN's deterministic algorithms on (as
   train_ensemble sets them) and then off, to show what determinism costs;
2. profiled: 2 ensemble steps (16 member-steps) under torch.profiler,
   tracing device activity only, giving device time by kernel, grouped into
   the port's kernels, convolutions, GEMMs, the optimizer/EMA and the rest.

The device's idle share is printed against both wall times. Run from the
repository root:

    python3 scripts/profile_torch_training.py [--bf16]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_torch_sampling import group  # noqa: E402

MEMBERS, BATCH, IMAGES = 8, 64, 50_000
WARM_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 10, 2


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.data import sample_removal
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
    from group_attribution_for_diffusion_models_tpu_torch.parallel import EnsembleTrainer
    from group_attribution_for_diffusion_models_tpu_torch.training import make_optimizer

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bf16", action="store_true", help="bf16 compute, f32 parameters")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config("cifar")
    images = np.random.default_rng(0).integers(0, 256, (IMAGES, 32, 32, 3), dtype=np.uint8)
    trainer = EnsembleTrainer(
        tx=make_optimizer("adam", lr=cfg.train.optimizer.lr),
        schedule=make_schedule(cfg.scheduler, dev), spec=cfg.scheduler, images_u8=images,
        member_indices=[sample_removal("shapley", IMAGES, seed=m)[0] for m in range(MEMBERS)],
        batch_size=BATCH, device=dev, common_noise=True,
    )
    states = trainer.init_state(
        lambda seed: build_unet(cfg.unet, seed, compute_dtype=compute_dtype), seed=0)

    def timed(steps: int, seed: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(states, steps, seed=seed)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps

    step_s = {}
    for deterministic in (True, False):
        torch.backends.cudnn.deterministic = deterministic
        timed(WARM_STEPS, 0)
        step_s[deterministic] = timed(TIMED_STEPS, 1)
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = timed(PROFILED_STEPS, 2) * PROFILED_STEPS * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

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
    member_steps = MEMBERS * PROFILED_STEPS
    busy_step = busy / PROFILED_STEPS
    det_ms = step_s[True] * 1e3
    print(f"{card}; torch {torch.__version__}; CIFAR UNet2D, f32 parameters, "
          f"{'bf16' if args.bf16 else 'f32'} compute, {MEMBERS} members, batch {BATCH}")
    print(f"unprofiled, {TIMED_STEPS} ensemble steps after {WARM_STEPS} warm-up: "
          f"{det_ms:.2f} ms/step with cuDNN deterministic "
          f"({MEMBERS / step_s[True]:.3f} member-steps/s), {step_s[False] * 1e3:.2f} "
          f"ms/step without; idle share {max(0.0, 1 - busy_step / det_ms):.3f} "
          f"(against the profiled device busy time)")
    print(f"profiled, {PROFILED_STEPS} ensemble steps ({member_steps} member-steps): wall "
          f"{wall_ms:.2f} ms, device busy {busy:.2f} ms ({busy_step:.2f} ms/step), idle "
          f"share {max(0.0, 1 - busy / wall_ms):.3f}; peak {peak_gib:.2f} GiB")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:32s} {ms:9.3f} ms {100 * ms / busy:5.1f}%  launches {n}")
    print("top kernels:")
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:9.3f} ms x{n:5d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
