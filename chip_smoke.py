#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):

1. card: name and power limit from nvidia-smi; build every CUDA kernel from
   the sources in ``group_attribution_for_diffusion_models_tpu_torch/csrc``.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the CIFAR sampling shapes and a few others, in float32 and bfloat16, with
   kernel, plain and library (SDPA, F.group_norm + F.silu) times.
3. forward: the full-width CIFAR UNet2D (random weights from a seed) on the
   card against the same model on the CPU, batch 4, float32.
4. main path: a seeded random-init full-width CIFAR checkpoint sampled
   through ``cli.generate_samples.main`` (2 batches of 64 images x 100 DDIM
   steps; the second batch's time is the warm one), with the kernels'
   launch counters reset just before and read just after.
5. reference: 5 DDIM steps of the same model on the card against the CPU
   from the same initial noise.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s of
# float32 outside the tensor cores and of bf16 on them (dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# (atol, rtol) of kernel against plain version; see tests/test_torch_kernels_cuda.py.
TOL = {"float32": (5e-5, 1e-5), "bfloat16": (1e-2, 2**-7)}
CIFAR_FWD_ATOL = 5e-4  # 22 resnets of f32 convs summed in other orders
SAMPLE_ATOL = 2e-3  # images in [0, 1] after 5 DDIM steps of that forward
ATTN_SHAPES = [  # (B, Sq, Skv, H, D)
    (64, 256, 256, 1, 256),  # CIFAR down_1 / up_2 at 16x16, sampling batch 64
    (64, 16, 16, 1, 256),    # CIFAR mid block at 4x4
    (8, 1024, 1024, 14, 32),  # celeba level 1
    (2, 130, 77, 2, 40),     # ragged queries and keys, ragged head dim
]
GN_SHAPES = [(64, 128, 32, 32), (64, 256, 4, 4)]  # CIFAR levels 0 and 3, G=32
STEPS, BATCH, N_BATCHES = 100, 64, 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, dtype: str):
    """(max abs error, within tolerance) of a kernel output against its
    plain version: |got - want| <= atol + rtol |want| everywhere."""
    atol, rtol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return diff.max().item(), ok


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_attention(torch, F, ops, dev):
    rows = {}
    for (b, sq, skv, h, d) in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                       for s in (sq, skv, skv))
            got = ops.attention_kernel(q, k, v)
            want = ops.attention_plain(q, k, v)
            torch.cuda.synchronize()
            err, ok = compare(got, want, name)
            ms = cuda_ms(torch, lambda: ops.attention_kernel(q, k, v))
            plain_ms = cuda_ms(torch, lambda: ops.attention_plain(q, k, v))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            bms, by = bound(nbytes, 4.0 * b * h * sq * skv * d, name)
            log(f"[kernels] attention B={b} Sq={sq} Skv={skv} H={h} D={d} {name}: "
                f"max_abs_err={err:.3g} (tol {TOL[name]}) kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bms:.4f} ({by})")
            if not ok:
                raise AssertionError(f"attention kernel disagrees: {err}, tol {TOL[name]}")
            rows[(b, sq, skv, h, d, name)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by)
    return rows


def check_group_norm(torch, F, ops, dev):
    rows = {}
    for shape in GN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            for silu in (True, False):
                g = torch.Generator(device=dev).manual_seed(1)
                x = (torch.randn(shape, generator=g, device=dev) * 3 + 0.5).to(dtype)
                gamma = torch.randn(shape[1], generator=g, device=dev) + 1
                beta = torch.randn(shape[1], generator=g, device=dev)
                args = (x, gamma, beta, 32, 1e-6, silu, dtype)
                got = ops.group_norm_kernel(*args)
                want = ops.group_norm_silu_plain(*args)
                torch.cuda.synchronize()
                err, ok = compare(got[0], want[0], name)
                stats = [compare(a, w, "float32") for a, w in zip(got[1:], want[1:])]
                stat_err = max(e for e, _ in stats)
                stat_ok = all(o for _, o in stats)
                ms = cuda_ms(torch, lambda: ops.group_norm_kernel(*args))
                plain_ms = cuda_ms(torch, lambda: ops.group_norm_silu_plain(*args))

                def library():
                    y = F.group_norm(x, 32, gamma.to(dtype), beta.to(dtype), 1e-6)
                    return F.silu(y) if silu else y

                lib_ms = cuda_ms(torch, library)
                n = x.numel()
                nbytes = 2 * n * x.element_size() + 2 * shape[1] * 4 + 2 * shape[0] * 32 * 4
                bms, by = bound(nbytes, n * (11.0 if silu else 7.0), "float32")
                log(f"[kernels] group_norm {tuple(shape)} G=32 silu={silu} {name}: "
                    f"max_abs_err={err:.3g} (tol {TOL[name]}) stats_err={stat_err:.3g} "
                    f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={bms:.4f} ({by})")
                if not (ok and stat_ok):
                    raise AssertionError(f"group norm kernel disagrees: {err}, {stat_err}")
                rows[(shape, name, silu)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bms, bound_by=by)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F
    from PIL import Image

    from group_attribution_for_diffusion_models_tpu_torch import ops
    from group_attribution_for_diffusion_models_tpu_torch.cli import generate_samples
    from group_attribution_for_diffusion_models_tpu_torch.config.registry import get_config
    from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_sampler
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
    from group_attribution_for_diffusion_models_tpu_torch.ops import _build
    from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {len(libs)} libraries from csrc/ in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(os.path.basename(p) for p in libs.values()))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attn_rows = check_attention(torch, F, ops, dev)
    gn_rows = check_group_norm(torch, F, ops, dev)

    spec = get_config("cifar").unet
    model = build_unet(spec, seed=0).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 3, 32, 32)).astype(np.float32))
    t = torch.tensor([999, 500, 20, 0])
    with torch.no_grad():
        want = model(x, t)
        model.to(dev)
        ops.attention_kernel.launches = ops.group_norm_kernel.launches = 0
        got = model(x.to(dev), t.to(dev)).cpu()
    counts = (ops.attention_kernel.launches, ops.group_norm_kernel.launches)
    err = (got - want).abs().max().item()
    log(f"[forward] CIFAR UNet2D ({sum(p.numel() for p in model.parameters())} params) "
        f"batch 4 f32, card vs CPU: max_abs_err={err:.3g} (tol {CIFAR_FWD_ATOL}), "
        f"|out|max={want.abs().max().item():.3g}, launches attention={counts[0]} "
        f"group_norm={counts[1]}")
    if not (err <= CIFAR_FWD_ATOL and counts == (6, 51)):
        raise AssertionError("CIFAR forward on the card disagrees with the CPU")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model_dir, out = os.path.join(tmp, "model"), os.path.join(tmp, "samples")
        sd = model.cpu().state_dict()
        save_checkpoint(model_dir, 0, sd, sd, unet_spec=spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.attention_kernel.launches = ops.group_norm_kernel.launches = 0
        t0 = time.perf_counter()
        summary = generate_samples.main([
            "--dataset", "cifar", "--load", model_dir, "--sample_outdir", out,
            "--n_samples", str(BATCH * N_BATCHES), "--batch_size", str(BATCH),
            "--num_inference_steps", str(STEPS), "--device", "cuda",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"attention": ops.attention_kernel.launches,
                    "group_norm": ops.group_norm_kernel.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        secs = [summary["batch_seconds"][b] for b in range(N_BATCHES)]
        log(f"[main] generate_samples cifar {N_BATCHES} batches of {BATCH} images x {STEPS} "
            f"DDIM steps f32 on {card}: s/batch {', '.join(f'{s:.3f}' for s in secs)} "
            f"(last: {BATCH / secs[-1]:.2f} images/s), call {wall:.3f} s, "
            f"peak {peak_gib:.2f} GiB, launches {launches}")
        forwards = N_BATCHES * STEPS
        if launches != {"attention": 6 * forwards, "group_norm": 51 * forwards}:
            raise AssertionError(f"main path launches {launches}")
        pngs = sorted(n for n in os.listdir(out) if n.endswith(".png"))
        imgs = np.stack([np.asarray(Image.open(os.path.join(out, n))) for n in pngs])
        log(f"[main] {len(pngs)} PNGs {imgs.shape[1:]} {imgs.dtype}, "
            f"mean {imgs.mean():.2f}, std {imgs.std():.2f}")
        if (len(pngs) != BATCH * N_BATCHES or imgs.shape[1:] != (32, 32, 3)
                or not np.isfinite(imgs).all() or imgs.std() == 0):
            raise AssertionError("generate_samples did not write the distinct 32x32 RGB PNGs")

    # Reference: the sampler on the card against the CPU from the same noise.
    model.eval()
    cfg = get_config("cifar")
    noise = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    cpu_imgs = make_sampler(model, cfg.scheduler, (2, 3, 32, 32), device="cpu",
                            num_inference_steps=5)(init_noise=noise)
    model.to(dev)
    gpu_imgs = make_sampler(model, cfg.scheduler, (2, 3, 32, 32), device=dev,
                            num_inference_steps=5)(init_noise=noise).cpu()
    err = (gpu_imgs - cpu_imgs).abs().max().item()
    log(f"[reference] 5 DDIM steps, batch 2, card vs CPU: max_abs_err={err:.3g} "
        f"(tol {SAMPLE_ATOL}), finite={bool(torch.isfinite(gpu_imgs).all())}")
    if not (err <= SAMPLE_ATOL and torch.isfinite(gpu_imgs).all()):
        raise AssertionError("sampling on the card disagrees with the CPU")

    main_attn = attn_rows[(64, 256, 256, 1, 256, "float32")]
    main_gn = gn_rows[((64, 128, 32, 32), "float32", True)]
    kernels = [
        dict(name="attention_fwd", route="cuda",
             source="group_attribution_for_diffusion_models_tpu_torch/csrc/attention.cu",
             # also the head-packed _hp_fwd_kernel (attention.py:309), same function
             replaces="group_attribution_for_diffusion_models_tpu/ops/attention.py:82",
             launches=launches["attention"], **main_attn),
        dict(name="group_norm_silu_fwd", route="cuda",
             source="group_attribution_for_diffusion_models_tpu_torch/csrc/group_norm.cu",
             replaces="group_attribution_for_diffusion_models_tpu/ops/group_norm.py:68",
             launches=launches["group_norm"], **main_gn),
    ]
    for row in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err"):
            if not math.isfinite(row[key]):
                raise AssertionError(f"{row['name']}: {key} is not finite")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
