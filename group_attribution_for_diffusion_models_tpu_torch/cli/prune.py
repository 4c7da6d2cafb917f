"""Structurally prune a trained U-Net checkpoint.

Port of the JAX package's ``cli/prune.py``: importance (magnitude, taylor,
diff-pruning or random) selects each resnet block's hidden channels, the
model's ``params`` (not its EMA) are sliced, and the pruned architecture is
saved as a step-0 checkpoint whose EMA equals its params, with the pruned
spec in its ``meta.json``, under ``<outdir>/<dataset>/prune/models/full``.
``train_ensemble --method prune_fine_tune --load <that dir>`` fine-tunes
from it. Taylor importance runs forward and backward passes on the device
(the kernels on the card). Runs on CUDA unless ``--device cpu`` is given.

Usage (smoke, CPU):
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.prune \\
        --dataset synthetic_64x8 --load /tmp/out/synthetic_64x8/retrain/models/full \\
        --pruning_ratio 0.3 --pruner magnitude --outdir /tmp/out --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data import create_dataset
from ..diffusion.schedulers import make_schedule
from ..models.unet2d import UNet2D
from ..pruning import (
    count_params,
    magnitude_importance,
    prune_unet,
    random_importance,
    taylor_importance,
)
from ..utils.ckpt import load_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from .common import add_common_args, checkpoint_spec, config_for, model_output_dir


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--load", type=str, required=True,
                        help="model dir with the trained full-model ckpt")
    parser.add_argument("--pruning_ratio", type=float, default=0.3)
    parser.add_argument("--pruner", type=str, default="magnitude",
                        choices=["magnitude", "taylor", "diff-pruning", "random"])
    parser.add_argument("--thr", type=float, default=0.05,
                        help="diff-pruning loss threshold")
    parser.add_argument("--taylor_batch_size", type=int, default=64)
    parser.add_argument("--timestep_stride", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI. Returns a summary dict: the output model dir, the pruned
    spec, the parameter counts before and after and the seconds the scoring
    and slicing took."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_for(args.dataset)
    spec = checkpoint_spec(args.load, cfg.unet)
    params = load_checkpoint(args.load)["params"]

    t0 = time.time()
    if args.pruner == "magnitude":
        importance = magnitude_importance(params)
    elif args.pruner == "random":
        importance = random_importance(params, seed=args.opt_seed)
    else:  # taylor / diff-pruning accumulate gradients over timesteps
        model = UNet2D(spec)
        model.load_state_dict(params)
        importance = taylor_importance(
            model.to(device), make_schedule(cfg.scheduler, device),
            create_dataset(args.dataset, train=True, device=device).images,
            num_timesteps=cfg.scheduler.num_train_timesteps,
            timestep_stride=args.timestep_stride,
            loss_threshold=args.thr if args.pruner == "diff-pruning" else None,
            seed=args.opt_seed,
            batch_size=args.taylor_batch_size,
        )
        del model

    n_before = count_params(params)
    new_spec, new_params = prune_unet(spec, params, args.pruning_ratio, importance)
    seconds = time.time() - t0
    n_after = count_params(new_params)
    print(
        f"pruned {args.pruner} ratio={args.pruning_ratio}: "
        f"{n_before:,} -> {n_after:,} params ({n_after / n_before:.1%}) in {seconds:.1f}s"
    )

    out_dir = model_output_dir(args.outdir, args.dataset, "prune", "full")
    save_checkpoint(out_dir, 0, new_params, new_params, unet_spec=new_spec)
    # A forward of the pruned model, as the JAX CLI's test inference.
    pruned = UNet2D(new_spec)
    pruned.load_state_dict(new_params)
    pruned = pruned.to(device).eval()
    x0 = torch.zeros((1, new_spec.in_channels, new_spec.sample_size, new_spec.sample_size),
                     device=device)
    with torch.no_grad():
        out = pruned(x0, torch.zeros((1,), dtype=torch.long, device=device))
    if not np.isfinite(out.cpu().numpy()).all():
        raise RuntimeError("the pruned model's forward is not finite")
    print(f"pruned model saved to {out_dir}")
    return {"model_dir": out_dir, "spec": new_spec, "params_before": n_before,
            "params_after": n_after, "seconds": seconds}


if __name__ == "__main__":
    main()
