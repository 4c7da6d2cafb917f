"""Compute projected per-sample gradient features (TRAK / D-TRAK inputs).

Port of the JAX package's ``cli/grad_features.py``. The per-sample gradient
is ``torch.func.vmap(torch.func.grad(f))`` through the port's kernels, one
batched call per timestep, and the timestep mean is projected by the JL
kernel (``ops/jl_projection.py``); only one batch of (B, n_params)
gradients exists at a time.

Sources: the training set (``--source train``), samples drawn on the fly
from the EMA weights (``generated``), or gradients along the sampling
trajectory (``generated_journey``); the gradients are always those of the
raw weights. Outputs, as the JAX CLI writes them: an ``.npz`` feature store
{train_features | gen_features, group_labels}, merged into an existing one,
for ``cli.traks``; the ``<save_path>_<source>_mm.npy`` memmap, filled one
batch at a time; and ``<save_path>_group.csv`` mapping train rows to groups
(written by the train source only: the JAX CLI also writes it, with zero
labels, for a generated source, over the train source's).

Each batch draws its samples from a generator seeded from (seed, batch) and
its feature noise (q-sample and output-function noise) from one seeded from
(seed + 1, batch): a generated image's features never reuse the latent it
was sampled from. Runs on CUDA unless ``--device cpu`` is given, with TF32
off. `main` returns a summary: shapes, seconds per batch and kernel launches.

Latent (VQ-VAE) workloads differentiate the U-Net in the latent space it
was trained in, as the JAX CLI does: the train source reads the dataset's
VQ latents through the tagged cache (``cli/common.py::dataset_latents``,
``--vqvae_weights`` else the seeded random tower) times the VQ-VAE's
scaling factor; the generated source takes the sampler's raw final latents
(not decoded, not rescaled); the journey its latent trajectory.
"""

from __future__ import annotations

import argparse
import os
import time
from functools import partial

import numpy as np
import torch

from .. import ops
from ..attributions.methods.trak import (
    OUTPUT_FNS,
    make_grad_feature_fn,
    make_journey_feature_fn,
)
from ..data import create_dataset
from ..diffusion import make_schedule, sample_loop, sample_with_trajectory
from ..models import UNet2D
from ..models.lora import attention_params_filter, probe_sketch_init
from ..ops.jl_projection import jl_project
from ..utils.ckpt import load_checkpoint
from ..utils.device import resolve_device
from .common import add_common_args, checkpoint_spec, config_for, dataset_latents
from .generate_samples import batch_generator


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--load", type=str, required=True, help="model dir")
    parser.add_argument("--source", type=str, default="train",
                        choices=["train", "generated", "generated_journey"])
    parser.add_argument("--output_fn", type=str, default="loss",
                        choices=list(OUTPUT_FNS))
    parser.add_argument("--proj_dim", type=int, default=4096)
    parser.add_argument("--num_timesteps", type=int, default=10)
    parser.add_argument("--t_strategy", type=str, default="uniform",
                        choices=["uniform", "cumulative"])
    parser.add_argument("--proj_seed", type=int, default=0)
    parser.add_argument("--grad_mode", type=str, default="full",
                        choices=["full", "probe", "attn_full"],
                        help="probe = Kronecker-probe gradient sketching "
                             "(attention projections only; the per-sample "
                             "gradients are sketched in the backward pass, "
                             "never formed); attn_full = exact per-sample "
                             "gradients of the same attention projections")
    parser.add_argument("--sketch_k", type=int, default=64,
                        help="input-side sketch rows per projection "
                             "(--grad_mode probe)")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--n_samples", type=int, default=64,
                        help="generated-source sample count")
    parser.add_argument("--max_examples", type=int, default=None)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def _load_model(state, key: str, spec, device) -> UNet2D:
    model = UNet2D(spec)
    model.load_state_dict(state[key])
    return model.to(device).eval()


def _save_store(path: str, payload: dict) -> None:
    """Write the .npz store, merged into an existing one (train and
    generated features are built by separate calls)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if os.path.exists(path):
        old = dict(np.load(path))
        old.update(payload)
        payload = old
    np.savez(path, **payload)


def main(argv=None):
    """Run the CLI; returns {"source", "features_shape", "grad_dim",
    "batch_seconds", "grad_seconds", "jl_seconds", "sample_seconds",
    "launches", "save_path"}: a batch's seconds split into its timestep-mean
    gradients and their JL projection, each to a device synchronise."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_for(args.dataset)
    latent = cfg.vqvae is not None
    spec = checkpoint_spec(args.load, cfg.unet)
    state = load_checkpoint(args.load)
    model = _load_model(state, "params", spec, device)
    schedule = make_schedule(cfg.scheduler, device)
    launches0 = ops.launch_counts()
    shape = (spec.in_channels, spec.sample_size, spec.sample_size)
    sample_s = 0.0

    def feature_generator(b: int) -> torch.Generator:
        """Feature noise of batch b: a stream apart from sampling's."""
        return batch_generator(args.seed + 1, b, device)

    def sample_batches(sample):
        """Samples from the EMA weights, `batch_size` at a time, each batch
        from a generator seeded from (seed, batch index)."""
        nonlocal sample_s
        ema = _load_model(state, "ema_params", spec, device)
        for b, i in enumerate(range(0, args.n_samples, args.batch_size)):
            t0 = time.perf_counter()
            out = sample(ema, schedule, cfg.scheduler,
                         (min(args.batch_size, args.n_samples - i), *shape), device=device,
                         generator=batch_generator(args.seed, b, device),
                         num_inference_steps=args.num_inference_steps)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            sample_s += time.perf_counter() - t0
            yield out

    batch_seconds, grad_seconds = [], []

    def projected(gradients) -> np.ndarray:
        """One batch's features: `gradients()` (its timestep-mean per-sample
        gradients), then their projection, each timed."""
        t0 = time.perf_counter()
        g = gradients()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        out = jl_project(g, args.proj_dim, seed=args.proj_seed).cpu().numpy()
        batch_seconds.append(time.perf_counter() - t0)
        grad_seconds.append(t1 - t0)
        return out

    if args.source == "generated_journey":
        # Journey TRAK: gradients at the latents the sampler visited (full
        # gradients whatever --grad_mode says, as in the JAX CLI).
        journey_fn = make_journey_feature_fn(
            model, schedule, cfg.scheduler, output_fn=args.output_fn,
            proj_dim=args.proj_dim, proj_seed=args.proj_seed)
        grad_dim, feats = journey_fn.dim, []
        for b, (_, traj, ts) in enumerate(sample_batches(sample_with_trajectory)):
            feats.append(projected(lambda: journey_fn.mean_gradients(
                traj, ts, generator=feature_generator(b))))
        feats = np.concatenate(feats)
        # group_labels belong to the train rows; generated features never touch them.
        _save_store(args.save_path, {"gen_features": feats})
        print(f"journey gen_features {feats.shape} -> {args.save_path}")
        return _summary(args, feats, grad_dim, batch_seconds, grad_seconds, sample_s,
                        launches0)

    sketch_probe = params_filter = None
    if args.grad_mode == "probe":
        sketch_probe = probe_sketch_init(
            model, k=args.sketch_k, generator=torch.Generator().manual_seed(args.proj_seed))
        if not sketch_probe:
            raise SystemExit("--grad_mode probe needs attention projections "
                             "(to_q/to_k/to_v/to_out) in the model; this architecture "
                             "has none")
    elif args.grad_mode == "attn_full":
        params_filter = attention_params_filter(model)
        if params_filter is None:
            raise SystemExit("--grad_mode attn_full needs attention projections "
                             "(to_q/to_k/to_v/to_out) in the model; this architecture "
                             "has none")
    feat_fn = make_grad_feature_fn(
        model, schedule, cfg.scheduler, output_fn=args.output_fn,
        proj_dim=args.proj_dim, num_timesteps=args.num_timesteps,
        t_strategy=args.t_strategy, proj_seed=args.proj_seed,
        sketch_probe=sketch_probe, params_filter=params_filter)

    if args.source == "train":
        dataset = create_dataset(args.dataset, train=True, device=device)
        images = dataset.images
        if latent:
            latents, _, _ = dataset_latents(args, cfg, dataset, device)
            images = latents * cfg.vqvae.scaling_factor
        images = images.transpose(0, 3, 1, 2)  # NHWC -> NCHW, a view
        labels = dataset.labels
    elif latent:  # the raw final latents
        raw = partial(sample_loop, postprocess=False)
        images = torch.cat(list(sample_batches(raw))).cpu().numpy()
        labels = np.zeros(len(images), np.int64)
    else:
        # [0, 1] pixels back to model space.
        images = torch.cat([x * 2.0 - 1.0 for x in sample_batches(sample_loop)]).cpu().numpy()
        labels = np.zeros(len(images), np.int64)
    if args.max_examples:
        images, labels = images[: args.max_examples], labels[: args.max_examples]

    # Projected rows stream to a disk-backed array, one batch at a time
    # (reference d_trak_grad.py:496-501).
    from numpy.lib.format import open_memmap

    os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
    stem = args.save_path.replace(".npz", "")
    feats = open_memmap(f"{stem}_{args.source}_mm.npy", mode="w+", dtype=np.float32,
                        shape=(len(images), args.proj_dim))
    for b, i in enumerate(range(0, len(images), args.batch_size)):
        batch = torch.from_numpy(np.ascontiguousarray(images[i:i + args.batch_size]))
        feats[i:i + args.batch_size] = projected(lambda: feat_fn.mean_gradients(
            batch.to(device), generator=feature_generator(b)))
        print(f"{min(i + args.batch_size, len(images))}/{len(images)} examples "
              f"({batch_seconds[-1]:.3f} s)", flush=True)
    feats.flush()
    feats = np.asarray(feats)

    if args.source == "train":
        _save_store(args.save_path, {"train_features": feats, "group_labels": labels})
        with open(f"{stem}_group.csv", "w") as f:
            f.write("row,group\n")
            f.writelines(f"{i},{g}\n" for i, g in enumerate(labels))
    else:
        _save_store(args.save_path, {"gen_features": feats})
    kind = "train_features" if args.source == "train" else "gen_features"
    print(f"{kind} {feats.shape} -> {args.save_path}")
    return _summary(args, feats, feat_fn.dim, batch_seconds, grad_seconds, sample_s,
                    launches0)


def _summary(args, feats, grad_dim, batch_seconds, grad_seconds, sample_s, launches0) -> dict:
    launches = {k: v - launches0[k] for k, v in ops.launch_counts().items()}
    return {"source": args.source, "features_shape": feats.shape, "grad_dim": grad_dim,
            "batch_seconds": batch_seconds, "grad_seconds": grad_seconds,
            "jl_seconds": [t - g for t, g in zip(batch_seconds, grad_seconds)],
            "sample_seconds": sample_s, "launches": launches, "save_path": args.save_path}


if __name__ == "__main__":
    main()
