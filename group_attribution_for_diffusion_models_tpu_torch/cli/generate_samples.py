"""Generate image samples from a trained checkpoint into PNG directories.

Port of the JAX package's ``cli/generate_samples.py``: batched DDIM sampling
from the EMA params into ``--sample_outdir``, with ``generation_state.json``
recording finished batches so an interrupted run resumes where it stopped.
Each batch draws its initial noise from a generator seeded from
(seed, batch index), so a resumed batch is the batch it would have been.

Latent workloads (``celeba``, ``synthetic_*_ldm``) sample U-Net latents and
decode them with the VQ-VAE (``--vqvae_weights``, else the seeded random
tower) after the denoise loop, so their PNGs are the VQ-VAE's image size
(256x256 for CelebA-HQ).

Runs on CUDA unless ``--device cpu`` is given. ``--dtype fp32`` turns off
TF32 in cuDNN convolutions and matmuls, so float32 means float32.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..diffusion.sampling import make_sampler
from ..models.unet2d import UNet2D
from ..utils.ckpt import load_checkpoint
from ..utils.device import resolve_device
from .common import add_common_args, checkpoint_spec, config_for, vq_decode_fn_for

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--load", type=str, required=True, help="model dir")
    parser.add_argument("--n_samples", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--sample_outdir", type=str, required=True)
    parser.add_argument("--use_ema", action="store_true", default=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    parser.add_argument("--dtype", choices=sorted(_DTYPES), default="fp32",
                        help="U-Net compute dtype")
    return parser.parse_args(argv)


def batch_generator(seed: int, batch: int, device: torch.device) -> torch.Generator:
    """Generator for one batch, seeded from (seed, batch) (the JAX CLI's
    fold_in(PRNGKey(seed), batch))."""
    state = np.random.SeedSequence([seed, batch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


def main(argv=None):
    """Run the CLI; returns {"batch_seconds": {batch: seconds}} for the
    batches this call generated (sampling through PNG writing)."""
    from PIL import Image

    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype]
    if device.type == "cuda" and dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print("fp32: TF32 off for cuDNN convolutions and CUDA matmuls")
    cfg = config_for(args.dataset)
    spec = checkpoint_spec(args.load, cfg.unet)
    state = load_checkpoint(args.load)
    model = UNet2D(spec)
    model.load_state_dict(state["ema_params"] if args.use_ema else state["params"])
    model.to(device=device, dtype=dtype).eval()

    os.makedirs(args.sample_outdir, exist_ok=True)
    progress_path = os.path.join(args.sample_outdir, "generation_state.json")
    done_batches = set()
    if os.path.exists(progress_path):
        with open(progress_path) as f:
            done_batches = set(json.load(f)["done_batches"])
        print(f"resuming: {len(done_batches)} batches already complete")

    batch = min(args.batch_size, args.n_samples)
    shape = (batch, spec.in_channels, spec.sample_size, spec.sample_size)
    sampler = make_sampler(
        model, cfg.scheduler, shape, device=device,
        num_inference_steps=args.num_inference_steps,
        decode_fn=vq_decode_fn_for(cfg, args.vqvae_weights, device=device),
    )

    n_batches = -(-args.n_samples // batch)
    batch_seconds = {}
    for b in range(n_batches):
        if b in done_batches:
            continue
        t0 = time.perf_counter()
        imgs = sampler(generator=batch_generator(args.seed, b, device))
        if not torch.isfinite(imgs).all():
            raise FloatingPointError(f"batch {b}: non-finite samples")
        u8 = (imgs * 255).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
        for i in range(len(u8)):
            idx = b * batch + i
            if idx >= args.n_samples:
                break
            arr = u8[i]
            if arr.shape[-1] == 1:
                arr = arr[..., 0]
            Image.fromarray(arr).save(
                os.path.join(args.sample_outdir, f"sample_{idx:06d}.png")
            )
        done_batches.add(b)
        with open(progress_path, "w") as f:
            json.dump({"done_batches": sorted(done_batches)}, f)
        batch_seconds[b] = time.perf_counter() - t0
        print(f"batch {b + 1}/{n_batches} written ({batch_seconds[b]:.3f} s)", flush=True)
    print(f"samples in {args.sample_outdir}")
    return {"batch_seconds": batch_seconds}


if __name__ == "__main__":
    main()
