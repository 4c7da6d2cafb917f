"""Unlearn a removal subset from a trained model and score it, in one process.

Port of the JAX package's ``cli/unlearn.py`` (reference
unconditional_generation/unlearn.py:267-971), the per-subset inner job of
Shapley estimation with the paper's unlearning baselines. Methods:

* iu / iu_u: WoodFisher influence unlearning (`unlearn.influence_unlearn`);
* gd / gd_u: fine-tune on the remaining set with the config's optimizer;
* ga / ga_u: gradient ascent on the removed set (the optimizer's maximize);
* lora / lora_u: LoRA (``--lora_rank``) on every attention projection,
  AdamW on the LoRA tree alone with the base frozen, then merged.

Then DDIM sampling (``--n_samples`` from one noise drawn from seed 42) of
the unlearned model (gd/ga: its EMA; iu, lora: its weights) and the scores
of ``--model_behavior``: ``global``, FID, IS and precision/recall of the
InceptionV3 tower (the seeded random init, as the JAX CLI's) against the
first 4 x n_samples training images, or for latent workloads the diversity
entropy over the same tower's features; ``local``, MSE, NRMSE and SSIM
against the loaded model's EMA samples from the same noise; ``none``. One
JSONL row with the scores, ``unlearn_time`` and ``sampling_time``. Latent
workloads (``celeba``) unlearn in VQ latent space (the tagged latents
cache) and decode the samples for scoring.

Each step's timesteps and noise (gd, ga, lora) come from a generator seeded
with ``--opt_seed`` + step, as the JAX CLI keys its steps; iu draws from
seeds opt_seed, +1, +2. Runs on CUDA unless ``--device cpu`` is given; on
CUDA, float32 means float32 (TF32 off) and cuDNN runs deterministic
algorithms.

Usage (smoke, CPU):
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.unlearn \\
        --dataset synthetic_64x8 --method iu --load <model dir> \\
        --removal_dist shapley --removal_seed 1 --model_behavior local \\
        --n_samples 2 --num_inference_steps 2 --outdir /tmp/out --device cpu
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch
from torch.func import functional_call

from ..data import batch_iterator, create_dataset
from ..data.datasets import ArrayDataset
from ..diffusion.sampling import make_sampler
from ..diffusion.schedulers import ScheduleState, add_noise, antithetic_timesteps, make_schedule
from ..models.lora import lora_collection, lora_init, lora_merge
from ..models.unet2d import UNet2D, empty_unet
from ..models.vqvae import make_vq_decode_fn
from ..training.state import TrainState, make_optimizer
from ..training.train import make_train_step
from ..unlearn import influence_unlearn
from ..utils.ckpt import load_checkpoint
from ..utils.device import resolve_device, to_device
from ..utils.jsonl import append_record
from .common import (
    add_common_args,
    as_rgb,
    checkpoint_spec,
    config_for,
    dataset_latents,
    model_output_dir,
    provenance_row,
    save_removal_indices,
    setup_removal,
)

SAMPLE_SEED = 42  # the paired samples' noise (the JAX CLI's PRNGKey(42))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--method", type=str, default="gd",
                        choices=["iu", "iu_u", "gd", "gd_u", "ga", "ga_u", "lora", "lora_u"])
    parser.add_argument("--load", type=str, required=True,
                        help="model dir of the trained full model")
    parser.add_argument("--model_behavior", type=str, default="global",
                        choices=["global", "local", "none"])
    parser.add_argument("--training_steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--iu_ratio", type=float, default=1.0)
    parser.add_argument("--wf_batches", type=int, default=16)
    parser.add_argument("--lora_rank", type=int, default=16)
    parser.add_argument("--n_samples", type=int, default=64)
    parser.add_argument("--log_freq", type=int, default=100)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def lora_unlearn(model: UNet2D, schedule: ScheduleState, num_train_timesteps: int,
                 subset: ArrayDataset, rank: int, lr: float, steps: int, batch_size: int,
                 seed: int, log_freq: int) -> Dict[str, torch.Tensor]:
    """LoRA fine-tuning on `subset` with the base frozen: `lora_init` (rank
    `rank`, drawn from `seed`) on every attention projection, the epsilon MSE
    through the side branch, AdamW on the LoRA leaves alone; returns the
    base's state dict with the tree merged in."""
    device = next(model.parameters()).device
    tree = lora_init(model, rank=rank, generator=torch.Generator(device=device).manual_seed(seed))
    leaves = [ab[k] for ab in tree.values() for k in ("down", "up")]
    for leaf in leaves:
        leaf.requires_grad_(True)
    buffers = lora_collection(tree)
    tx = make_optimizer("adamw", lr=lr)
    opt_state = tx.init(leaves)
    batches = batch_iterator(subset, min(batch_size, len(subset)), seed)
    model.requires_grad_(False)  # frozen: no GroupNorm gamma/beta reduction either
    try:
        for i in range(steps):
            x = to_device(next(batches)[0], device)
            gen = torch.Generator(device=device).manual_seed(seed + i)
            t = antithetic_timesteps(gen, x.shape[0], num_train_timesteps, device)
            noise = torch.randn(x.shape, generator=gen, device=device)
            with torch.enable_grad():
                eps = functional_call(model, buffers, (add_noise(schedule, x, noise, t), t))
                loss = torch.mean((eps - noise) ** 2)
                grads = torch.autograd.grad(loss, leaves)
            tx.update(list(grads), opt_state, leaves)
            if (i + 1) % log_freq == 0:
                print(f"Step[{i + 1}/{steps}] loss={float(loss):.5f}", flush=True)
    finally:
        model.requires_grad_(True)
    # Copies: the merged dict must not alias the model, which samples on.
    base = {k: v.clone() for k, v in model.state_dict().items()}
    return lora_merge(base, {n: {k: v.detach() for k, v in ab.items()} for n, ab in tree.items()})


def main(argv=None):
    """Run the CLI. Returns a summary: the row written, the DB, the model
    dir, the scores, the seconds of unlearning, sampling and scoring (each to
    a device synchronise), for iu the seconds of its two average gradients
    and of the WoodFisher recursion, and the unlearned state dict."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    cfg = config_for(args.dataset)
    # Budget lookup key: iu/iu_u -> iu, ga/ga_u -> ga, gd/gd_u/lora* -> gd.
    method_base = {"iu": "iu", "ga": "ga"}.get(args.method.split("_")[0], "gd")
    training_steps = args.training_steps or cfg.train.training_steps.get(method_base, 200)
    batch_size = args.batch_size or cfg.train.batch_size

    dataset = create_dataset(args.dataset, train=True, device=device)
    remaining_idx, removed_idx = setup_removal(args, dataset)
    if len(removed_idx) == 0 or len(remaining_idx) == 0:
        raise SystemExit("unlearning needs nonempty remaining and removed sets")

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    decode_fn, train_ds = None, dataset
    if cfg.vqvae is not None:
        latents, vqvae, _ = dataset_latents(args, cfg, dataset, device)
        train_ds = ArrayDataset(latents * cfg.vqvae.scaling_factor, dataset.labels)
        decode_fn = make_vq_decode_fn(cfg.vqvae, vqvae=vqvae)

    spec = checkpoint_spec(args.load, cfg.unet)
    ckpt = load_checkpoint(args.load)
    model = empty_unet(spec)
    model.load_state_dict(ckpt["params"])
    model.to(device)
    schedule = make_schedule(cfg.scheduler, device)
    opt = cfg.train.optimizer

    sync()
    t0 = time.perf_counter()
    iu_seconds = None
    if args.method in ("iu", "iu_u"):
        iu_seconds = {}
        final = influence_unlearn(
            model, schedule, cfg.scheduler, train_ds.images[removed_idx],
            train_ds.images[remaining_idx], alpha=args.iu_ratio,
            batch_size=min(batch_size, 32), wf_batches=args.wf_batches, seed=args.opt_seed,
            seconds=iu_seconds)
    elif args.method in ("lora", "lora_u"):
        final = lora_unlearn(model, schedule, cfg.scheduler.num_train_timesteps,
                             train_ds.subset(remaining_idx), args.lora_rank, args.lr or 1e-4,
                             training_steps, batch_size, args.opt_seed, args.log_freq)
    else:  # gd / gd_u / ga / ga_u fine-tuning loops
        ga = args.method.startswith("ga")
        tx = make_optimizer(opt.name, lr=args.lr or opt.lr, weight_decay=opt.weight_decay,
                            grad_clip_norm=opt.grad_clip_norm, maximize=ga)
        state = TrainState.create(model, tx)
        step_fn = make_train_step(tx, schedule, cfg.scheduler)
        subset = train_ds.subset(removed_idx if ga else remaining_idx)
        batches = batch_iterator(subset, min(batch_size, len(subset)), args.opt_seed)
        for i in range(training_steps):
            gen = torch.Generator(device=device).manual_seed(args.opt_seed + i)
            metrics = step_fn(state, to_device(next(batches)[0], device), gen)
            if (i + 1) % args.log_freq == 0:
                print(f"Step[{i + 1}/{training_steps}] loss={float(metrics['loss']):.5f}",
                      flush=True)
        final = state.state_dicts()[1]  # the EMA weights sample, as the JAX CLI's
    sync()
    unlearn_time = time.perf_counter() - t0

    model_dir = model_output_dir(
        args.outdir, args.dataset, args.method, args.removal_dist, args.removal_seed,
        args.datamodel_alpha if args.removal_dist == "datamodel" else None,
    )
    save_removal_indices(model_dir, remaining_idx, removed_idx)

    scores: Dict = {}
    sampling_time = scoring_time = 0.0
    if args.model_behavior != "none":
        shape = (args.n_samples, spec.in_channels, spec.sample_size, spec.sample_size)
        noise = torch.randn(shape, device=device,
                            generator=torch.Generator(device=device).manual_seed(SAMPLE_SEED))
        model.eval()

        def sample(state_dict) -> torch.Tensor:
            model.load_state_dict(state_dict)
            return make_sampler(model, cfg.scheduler, shape, device=device,
                                num_inference_steps=args.num_inference_steps, kind="ddim",
                                decode_fn=decode_fn)(init_noise=noise).permute(0, 2, 3, 1)

        t0 = time.perf_counter()
        samples = sample(final)
        sync()
        sampling_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        if args.model_behavior == "global":
            scores = global_scores(cfg, dataset, samples.cpu().numpy(), args.n_samples, device)
        else:  # local: paired behaviors against the loaded model's EMA samples
            from ..utils.image_metrics import mse, nrmse, ssim

            full = sample(ckpt["ema_params"])
            scores = {"avg_mse": float(mse(full, samples).mean()),
                      "avg_nrmse": float(nrmse(full, samples).mean()),
                      "avg_ssim": float(ssim(full, samples).mean())}
        sync()
        scoring_time = time.perf_counter() - t0

    db = args.db or os.path.join(args.outdir, f"{args.dataset}_unlearn_db.jsonl")
    row = provenance_row(args, **scores, remaining_idx=remaining_idx, removed_idx=removed_idx,
                         unlearn_time=unlearn_time, sampling_time=sampling_time,
                         model_dir=model_dir)
    append_record(db, row)
    print(f"{args.method} done in {unlearn_time:.1f}s; scores={scores} -> {db}")
    return {"row": row, "db": db, "model_dir": model_dir, "scores": scores,
            "unlearn_seconds": unlearn_time, "sampling_seconds": sampling_time,
            "scoring_seconds": scoring_time, "iu_seconds": iu_seconds, "state_dict": final}


def global_scores(cfg, dataset, samples: np.ndarray, n_samples: int, device) -> Dict:
    """The global behaviors of `samples` (N, H, W, C) in [0, 1] through the
    seeded random InceptionV3, against the first 4 x n_samples training
    images: FID, IS and precision/recall, or for latent workloads (celeba)
    the diversity entropy over the same features (reference
    unlearn.py:787-803)."""
    from ..attributions.global_scores import (
        calculate_diversity_score,
        calculate_fid_from_features,
        compute_precision_recall,
        inception_score_from_logits,
        load_inception,
        make_feature_fn,
    )

    extract = make_feature_fn(load_inception(None, device=device))
    gen_feats, gen_logits = extract(as_rgb(samples))
    ref_feats, _ = extract(as_rgb(dataset.images[: 4 * n_samples] / 2 + 0.5))
    if cfg.vqvae is not None:
        div = calculate_diversity_score(ref_feats, gen_feats)
        return {k: div[k] for k in ("entropy", "cluster_count", "cluster_proportions")}
    scores = {"fid_value": calculate_fid_from_features(gen_feats, ref_features=ref_feats)}
    scores["is"], scores["is_std"] = inception_score_from_logits(gen_logits)
    scores["precision"], scores["recall"] = compute_precision_recall(ref_feats, gen_feats,
                                                                     device=device)
    return scores


if __name__ == "__main__":
    main()
