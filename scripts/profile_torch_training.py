#!/usr/bin/env python3
"""Where the time of the port's CIFAR ensemble train step goes, on one GPU.

Trains 8 full-width CIFAR UNet2D members (random init from a seed, float32
parameters, TF32 off; f32 compute, or bf16 with ``--bf16`` as
``train_ensemble --bf16``) at batch 64 through
`parallel.ensemble.EnsembleTrainer`, on seeded uint8 images of CIFAR-10's
size (50,000 x 32 x 32 x 3) with shapley removal subsets, in two ways from
the same initial weights and draws:

- stacked: the trainer's step (`cli.train_ensemble`'s path), every member in
  one vmapped forward and backward and one optimizer update of the stack;
- looped: the same members as TrainStates of their own, stepped one after
  another by `make_train_step` on the trainer's draws (the trainer before
  the members were stacked).

For each: 1. unprofiled, 3 warm-up ensemble steps, then 10 timed ones (host
clock, synchronised), with cuDNN's deterministic algorithms on (as
train_ensemble sets them) and then off, to show what determinism costs;
2. profiled, 2 ensemble steps (16 member-steps) under torch.profiler,
tracing device activity only, giving device time by kernel, grouped into
the port's kernels, convolutions, GEMMs, the optimizer/EMA and the rest,
and the peak memory. The time the device was busy is the union of the
trace's kernel intervals (`profile_torch_sampling.device_activity`); the
summed kernel time is printed beside it, by stream, and the idle share
against both wall times, unclamped.

3. the control: the stacked step's convolutions alone, outside vmap. Each
convolution the vmapped step issues (captured by a dispatch mode: the
grouped call, one group a member, that vmap makes of a member's own
weights) is run forward and backward as that one grouped call, and as 8
dense calls of one member each, on seeded tensors of its shapes, as many
times as one step calls it: event-timed with cuDNN's deterministic
algorithms on and off, and profiled (deterministic on) by kernel group.

Run from the repository root:

    python3 scripts/profile_torch_training.py [--bf16]
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_torch_sampling import device_activity, group  # noqa: E402

MEMBERS, BATCH, IMAGES = 8, 64, 50_000
WARM_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 10, 2
CONV_REPS = 5  # control: steps' worth of convolutions timed


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.data import sample_removal
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
    from group_attribution_for_diffusion_models_tpu_torch.parallel import EnsembleTrainer
    from group_attribution_for_diffusion_models_tpu_torch.parallel.ensemble import _step_seed
    from group_attribution_for_diffusion_models_tpu_torch.training import (
        make_optimizer, make_train_step, unstack_state)

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
    stacked = trainer.init_state(
        lambda seed: build_unet(cfg.unet, seed, compute_dtype=compute_dtype), seed=0)
    members = [unstack_state(stacked, m) for m in range(MEMBERS)]
    member_step = make_train_step(trainer.tx, trainer.schedule, trainer.spec)

    def looped_run(seed: int, steps: int) -> None:
        for i in range(steps):
            raw, t, noise = trainer.draws(_step_seed(seed, i))
            batch = trainer.batch(raw)
            for m, state in enumerate(members):
                member_step(state, batch[m], timesteps=t[m], noise=noise[m])

    runs = {"stacked": lambda seed, steps: trainer.run(stacked, steps, seed=seed),
            "looped": looped_run}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}; CIFAR UNet2D, f32 parameters, "
          f"{'bf16' if args.bf16 else 'f32'} compute, {MEMBERS} members, batch {BATCH}")
    for mode, run in runs.items():
        report(torch, profile, ProfilerActivity, mode, run)
    del members
    torch.cuda.empty_cache()
    conv_control(torch, profile, ProfilerActivity,
                 lambda: trainer.step(stacked, _step_seed(3, 0)), dev)
    return 0


def report(torch, profile, ProfilerActivity, mode: str, run) -> None:
    """Time, profile and print one way of stepping the members."""

    def timed(steps: int, seed: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(seed, steps)
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

    activity = device_activity(prof)
    busy, summed = activity["busy_ms"], activity["summed_ms"]
    if busy <= 0:
        raise SystemExit("the profiler recorded no device time")
    groups = {}
    for name, (ms, n) in activity["by_kernel"].items():
        g = groups.setdefault(group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    member_steps = MEMBERS * PROFILED_STEPS
    det_ms = step_s[True] * 1e3
    print(f"== {mode}")
    print(f"unprofiled, {TIMED_STEPS} ensemble steps after {WARM_STEPS} warm-up: "
          f"{det_ms:.2f} ms/step with cuDNN deterministic "
          f"({MEMBERS / step_s[True]:.3f} member-steps/s), {step_s[False] * 1e3:.2f} "
          f"ms/step without; idle share {1 - busy / PROFILED_STEPS / det_ms:.3f} "
          f"(against the profiled device busy time)")
    print(f"profiled, {PROFILED_STEPS} ensemble steps ({member_steps} member-steps): wall "
          f"{wall_ms:.2f} ms, device busy {busy:.2f} ms ({busy / PROFILED_STEPS:.2f} "
          f"ms/step; the union of the kernels' intervals), kernels summed {summed:.2f} ms "
          f"on {len(activity['streams'])} stream(s) "
          f"{ {s: round(ms, 2) for s, ms in activity['streams'].items()} }; idle share "
          f"{1 - busy / wall_ms:.3f}; peak {peak_gib:.2f} GiB (both ways' states are held)")
    if busy > wall_ms:
        print("  WARNING: device busy exceeds the wall time: the trace's clock and the "
              "host's disagree")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:32s} {ms:9.3f} ms {100 * ms / summed:5.1f}% of summed  launches {n}")
    print("top kernels:")
    for name, (ms, n) in sorted(activity["by_kernel"].items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:9.3f} ms x{n:5d}  {name[:110]}")


def conv_control(torch, profile, ProfilerActivity, step, dev) -> None:
    """Time the convolutions that one call of `step` (the stacked step)
    issues, alone and outside vmap: as the grouped calls it makes, and as
    dense calls of one member each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    conv = torch.ops.aten.convolution.default
    calls = collections.Counter()

    class Capture(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is conv:
                x, w, b, stride, padding, dilation, transposed, out_pad, groups = args
                calls[(tuple(x.shape), tuple(w.shape), b is not None, tuple(stride),
                       tuple(padding), tuple(dilation), transposed, tuple(out_pad), groups,
                       x.dtype)] += 1
            return func(*args, **(kwargs or {}))

    with Capture():
        step()
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype).requires_grad_()

    grouped, dense = [], []  # (fn, calls a step)
    for key, n in calls.items():
        xs, ws, bias, stride, padding, dilation, transposed, out_pad, groups, dtype = key
        x, w = randn(xs, dtype), randn(ws, dtype)
        b = randn((ws[1] * groups if transposed else ws[0],), dtype) if bias else None
        y = conv(x, w, b, stride, padding, dilation, transposed, out_pad, groups)
        dy = torch.randn(y.shape, generator=gen, device=dev, dtype=dtype)
        args = (stride, padding, dilation, transposed, out_pad)
        one = functools.partial(fwd_bwd, torch, x, w, b, dy, args, groups)
        grouped.append((one, n))
        if groups != MEMBERS:  # not one group a member: the same call
            dense.append((one, n))
            continue
        # Member m's slices, each a tensor of its own: a dense convolution.
        for xm, wm, bm, dym in zip(
                x.detach().chunk(groups, 1), w.detach().chunk(groups, 0),
                b.detach().chunk(groups, 0) if bias else [None] * groups,
                dy.chunk(groups, 1)):
            dense.append((functools.partial(
                fwd_bwd, torch, xm.contiguous().requires_grad_(),
                wm.contiguous().requires_grad_(),
                None if bm is None else bm.clone().requires_grad_(), dym.contiguous(), args,
                1), n))

    def run(fns, reps):
        for _ in range(reps):
            for fn, n in fns:
                for _ in range(n):
                    fn()

    print(f"== control: the stacked step's convolutions alone, outside vmap "
          f"({len(calls)} shapes, {sum(calls.values())} calls a step, forward and backward)")
    for label, fns in (("grouped, as vmap calls them", grouped),
                       (f"dense, {MEMBERS} calls of a member each", dense)):
        ms = {}
        for deterministic in (True, False):
            torch.backends.cudnn.deterministic = deterministic
            run(fns, 1)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(fns, CONV_REPS)
            end.record()
            torch.cuda.synchronize()
            ms[deterministic] = start.elapsed_time(end) / CONV_REPS
        torch.backends.cudnn.deterministic = True
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(fns, 1)
            torch.cuda.synchronize()
        activity = device_activity(prof)
        by_group = collections.Counter()
        for name, (k_ms, _) in activity["by_kernel"].items():
            by_group["transpose (cuDNN genericTranspose)" if "genericTranspose" in name
                     else group(name)] += k_ms
        print(f"{label}: {ms[True]:.2f} ms a step with cuDNN deterministic, {ms[False]:.2f} "
              f"without (events); profiled: device busy {activity['busy_ms']:.2f} ms, by group "
              f"{ {g: round(v, 2) for g, v in by_group.most_common()} }")


def fwd_bwd(torch, x, w, b, dy, args, groups) -> None:
    """One convolution, forward and backward to every input."""
    out = torch.ops.aten.convolution.default(x, w, b, *args, groups)
    torch.autograd.grad(out, [t for t in (x, w, b) if t is not None], dy)


if __name__ == "__main__":
    sys.exit(main())
