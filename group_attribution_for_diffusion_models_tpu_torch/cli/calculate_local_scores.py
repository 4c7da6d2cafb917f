"""Paired local model behaviors: the full model against a removal model.

Port of the JAX package's ``cli/calculate_local_scores.py`` (reference
unconditional_generation/calculate_local_scores.py:25,303-374). Both models
sample with DDIM (eta 0) from their EMA weights and the same initial noise,
so the pairing is exact; latent workloads decode both with the VQ decoder.
Per image: MSE, NRMSE and SSIM between the two samples, and the removal
model's diffusion loss (its raw weights) on the full model's samples,
averaged over ``--n_noises`` draws of a timestep and a noise per image; on
a latent workload the samples are re-encoded to VQ latents times the
scaling factor first, as the reference round-trips them. One JSONL row with
the JAX CLI's keys (``avg_*``, ``generated_image_{i}_{mse,nrmse,ssim,
simple_loss}``, the removal model's ``remaining_idx``/``removed_idx``) is
appended to ``--db`` (default ``<outdir>/<dataset>_local_db.jsonl``).

The initial noise comes from a generator seeded with ``--seed``; loss draw
i (timesteps, then noise) from one seeded from (seed, i). Runs on CUDA
unless ``--device cpu`` is given, with TF32 off. `main` returns the row and
the seconds of generation and of the loss.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..diffusion import add_noise, make_sampler, make_schedule
from ..diffusion.schedulers import ScheduleState
from ..models import UNet2D
from ..models.vqvae import load_vqvae, make_vq_decode_fn
from ..utils.ckpt import load_checkpoint, load_meta
from ..utils.device import resolve_device
from ..utils.image_metrics import mse, nrmse, ssim
from ..utils.jsonl import append_record
from .common import add_common_args, checkpoint_spec, config_for, provenance_row
from .generate_samples import batch_generator


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--full_model_dir", type=str, required=True)
    parser.add_argument("--removal_model_dir", type=str, required=True)
    parser.add_argument("--n_samples", type=int, default=16)
    parser.add_argument("--n_noises", type=int, default=4,
                        help="noise draws for the diffusion-loss behavior")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def load_models(model_dir: str, spec, device, keys=("ema_params",)) -> Tuple[List[UNet2D], dict]:
    """(one U-Net in eval mode on `device` for each state-dict key of the
    latest checkpoint under `model_dir`, its meta.json); the checkpoint's
    own spec wins over `spec` (a pruned model)."""
    spec = checkpoint_spec(model_dir, spec)
    state = load_checkpoint(model_dir)
    models = []
    for key in keys:
        model = UNet2D(spec)
        model.load_state_dict(state[key])
        models.append(model.to(device).eval())
    return models, load_meta(model_dir)


def paired_samples(full: UNet2D, removal: UNet2D, cfg, init_noise: torch.Tensor,
                   num_inference_steps: int, decode_fn: Optional[Callable] = None):
    """(full, removal) samples (B, H, W, C) in [0, 1], DDIM from the same
    initial noise (B, C, h, w), decoded by `decode_fn` when given."""
    out = []
    for model in (full, removal):
        sampler = make_sampler(model, cfg.scheduler, tuple(init_noise.shape),
                               device=init_noise.device,
                               num_inference_steps=num_inference_steps, decode_fn=decode_fn)
        out.append(sampler(init_noise=init_noise).permute(0, 2, 3, 1))
    return tuple(out)


def removal_loss(model: UNet2D, schedule: ScheduleState, x: torch.Tensor,
                 draws: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Per-image diffusion loss of `model` on x (B, C, H, W) in model space,
    averaged over the draws [(timesteps (B,), noise like x)]."""
    losses = []
    with torch.no_grad():
        for t, noise in draws:
            eps = model(add_noise(schedule, x, noise, t), t)
            losses.append(torch.mean((eps - noise) ** 2, dim=(1, 2, 3)))
    return torch.stack(losses).mean(dim=0)


def loss_draws(seed: int, n: int, shape, num_train_timesteps: int, device):
    """The n (timesteps, noise) draws of the loss, draw i from (seed, i)."""
    draws = []
    for i in range(n):
        gen = batch_generator(seed, i, device)
        t = torch.randint(0, num_train_timesteps, (shape[0],), generator=gen, device=device)
        draws.append((t, torch.randn(shape, generator=gen, device=device)))
    return draws


def main(argv=None):
    """Run the CLI; returns {"row", "db", "generation_seconds",
    "loss_seconds"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = config_for(args.dataset)
    (full,), _ = load_models(args.full_model_dir, cfg.unet, device)
    (rem_ema, rem), rem_meta = load_models(args.removal_model_dir, cfg.unet, device,
                                           ("ema_params", "params"))
    spec = full.spec
    vqvae = decode_fn = None
    if cfg.vqvae is not None:
        vqvae = load_vqvae(cfg.vqvae, args.vqvae_weights, device=device)
        decode_fn = make_vq_decode_fn(cfg.vqvae, vqvae=vqvae)

    shape = (args.n_samples, spec.in_channels, spec.sample_size, spec.sample_size)
    sync()
    t0 = time.perf_counter()
    init_noise = torch.randn(shape, device=device,
                             generator=torch.Generator(device=device).manual_seed(args.seed))
    imgs_full, imgs_rem = paired_samples(full, rem_ema, cfg, init_noise,
                                         args.num_inference_steps, decode_fn)
    sync()
    gen_time = time.perf_counter() - t0
    mses, nrmses, ssims = (f(imgs_full, imgs_rem).cpu().numpy() for f in (mse, nrmse, ssim))

    t0 = time.perf_counter()
    schedule = make_schedule(cfg.scheduler, device)
    x = imgs_full.permute(0, 3, 1, 2) * 2.0 - 1.0
    if vqvae is not None:
        with torch.no_grad():
            x = vqvae.encode(x) * cfg.vqvae.scaling_factor
    draws = loss_draws(args.seed, args.n_noises, x.shape, cfg.scheduler.num_train_timesteps,
                       device)
    losses = removal_loss(rem, schedule, x, draws).cpu().numpy()
    sync()
    loss_time = time.perf_counter() - t0

    row = provenance_row(
        args,
        remaining_idx=rem_meta.get("remaining_idx", []),
        removed_idx=rem_meta.get("removed_idx", []),
        generation_time=gen_time,
        avg_mse=float(mses.mean()),
        avg_nrmse=float(nrmses.mean()),
        avg_ssim=float(ssims.mean()),
        avg_total_loss=float(losses.mean()),
        **{
            f"generated_image_{i}_{k}": float(v[i])
            for i in range(args.n_samples)
            for k, v in [("mse", mses), ("nrmse", nrmses), ("ssim", ssims),
                         ("simple_loss", losses)]
        },
    )
    db = args.db or os.path.join(args.outdir, f"{args.dataset}_local_db.jsonl")
    append_record(db, row)
    print(f"avg_mse={mses.mean():.5f} avg_ssim={ssims.mean():.4f} "
          f"avg_nrmse={nrmses.mean():.4f} avg_loss={losses.mean():.5f} -> {db}")
    return {"row": row, "db": db, "generation_seconds": gen_time, "loss_seconds": loss_time}


if __name__ == "__main__":
    main()
