"""Per-inference-step local behaviors between the full and a removal model.

Port of the JAX package's ``cli/calculate_local_loss.py`` (reference
unconditional_generation/calculate_local_loss.py:253-653, which the
reference left unfinished). Both models run DDIM (eta 0) from their EMA
weights and the same initial noise, keeping the latent each step starts
from. At every inference step each model's prediction there gives an
estimate of the clean image (x0-hat, ``pred_original_sample``), decoded by
the VQ decoder on a latent workload and clipped to [0, 1]; the MSE and SSIM
between the two estimates, averaged over the batch, trace where the removal
model parts from the full one. One JSONL row with ``timesteps``,
``per_step_mse`` and ``per_step_ssim`` (and the removal model's
``remaining_idx``/``removed_idx``) is appended to ``--db`` (default
``<outdir>/<dataset>_local_loss_db.jsonl``).

The initial noise comes from a generator seeded with ``--seed``. Runs on
CUDA unless ``--device cpu`` is given, with TF32 off. `main` returns the row
and the seconds of the trajectories and per-step metrics together.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..diffusion import make_schedule, pred_original_sample, sample_with_trajectory
from ..models import UNet2D
from ..utils.device import resolve_device
from ..utils.image_metrics import mse, ssim
from ..utils.jsonl import append_record
from .calculate_local_scores import load_models
from .common import add_common_args, config_for, provenance_row, vq_decode_fn_for


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--full_model_dir", type=str, required=True)
    parser.add_argument("--removal_model_dir", type=str, required=True)
    parser.add_argument("--n_samples", type=int, default=8)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def per_step_metrics(full: UNet2D, removal: UNet2D, cfg, init_noise: torch.Tensor,
                     num_inference_steps: int, decode_fn: Optional[Callable] = None
                     ) -> Tuple[np.ndarray, List[float], List[float]]:
    """(timesteps, per-step batch-mean MSE, per-step batch-mean SSIM) of the
    two models' x0-hat along their paired DDIM trajectories from
    `init_noise` (B, C, h, w)."""
    device = init_noise.device
    schedule = make_schedule(cfg.scheduler, device)
    trajs = []
    for model in (full, removal):
        _, traj, ts = sample_with_trajectory(
            model, schedule, cfg.scheduler, tuple(init_noise.shape), device=device,
            init_noise=init_noise, num_inference_steps=num_inference_steps)
        trajs.append(traj)
    mses, ssims = [], []
    with torch.no_grad():
        for i, t in enumerate(ts.tolist()):
            t_b = torch.full((init_noise.shape[0],), int(t), dtype=torch.long, device=device)
            x0 = []
            for model, traj in zip((full, removal), trajs):
                est = pred_original_sample(schedule, model(traj[i], t_b), t_b, traj[i])
                if decode_fn is not None:
                    est = decode_fn(est)
                x0.append(torch.clamp(est / 2 + 0.5, 0, 1).permute(0, 2, 3, 1))
            mses.append(float(torch.mean(mse(*x0))))
            ssims.append(float(torch.mean(ssim(*x0))))
            print(f"t={int(t)} mse={mses[-1]:.5f} ssim={ssims[-1]:.4f}", flush=True)
    return ts.cpu().numpy(), mses, ssims


def main(argv=None):
    """Run the CLI; returns {"row", "db", "seconds"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_for(args.dataset)
    (full,), _ = load_models(args.full_model_dir, cfg.unet, device)
    (rem,), rem_meta = load_models(args.removal_model_dir, cfg.unet, device)
    spec = full.spec
    shape = (args.n_samples, spec.in_channels, spec.sample_size, spec.sample_size)
    init_noise = torch.randn(shape, device=device,
                             generator=torch.Generator(device=device).manual_seed(args.seed))
    decode_fn = vq_decode_fn_for(cfg, args.vqvae_weights, device=device)
    t0 = time.perf_counter()
    ts, per_step_mse, per_step_ssim = per_step_metrics(
        full, rem, cfg, init_noise, args.num_inference_steps, decode_fn)
    seconds = time.perf_counter() - t0

    db = args.db or os.path.join(args.outdir, f"{args.dataset}_local_loss_db.jsonl")
    row = provenance_row(args, remaining_idx=rem_meta.get("remaining_idx", []),
                         removed_idx=rem_meta.get("removed_idx", []), timesteps=ts,
                         per_step_mse=per_step_mse, per_step_ssim=per_step_ssim)
    append_record(db, row)
    print(f"per-timestep behaviors -> {db}")
    return {"row": row, "db": db, "seconds": seconds}


if __name__ == "__main__":
    main()
