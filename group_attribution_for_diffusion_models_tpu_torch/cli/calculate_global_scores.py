"""Compute global model behaviors (FID, IS, precision/recall) of one model.

Port of the JAX package's ``cli/calculate_global_scores.py``: sample
``--n_samples`` images from a checkpoint's EMA weights with DDIM (or read
``--sample_dir``), run the InceptionV3 tower once for FID features and IS
logits, compare against reference-set statistics (the first max(n_samples,
2048) training images; cached at ``--ref_stats`` with the tag of the tower
that made them, and recomputed when the tag differs), compute precision and
recall on Inception or VGG16 features, and append one JSONL row with
remaining_idx/removed_idx so the LDS tier can rebuild masks. ``--per_class``
averages FID over the class subdirectories of ``--sample_dir``.

Without weights files the towers start from seeded random inits: the scores
are self-consistent but not comparable to published ones. Runs on CUDA
unless ``--device cpu`` is given; on CUDA, TF32 is off, so float32 means
float32. Latent workloads sample latents and decode them with the VQ-VAE
(``--vqvae_weights``, else the seeded random tower).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..attributions.global_scores import (
    calculate_fid_from_features,
    compute_feature_stats,
    compute_precision_recall,
    inception_score_from_logits,
    inception_tag,
    load_inception,
    load_reference_stats,
    load_vgg16,
    make_feature_fn,
    make_vgg_feature_fn,
    save_stats,
)
from ..data import create_dataset
from ..diffusion.sampling import make_sampler
from ..models.unet2d import UNet2D
from ..utils.ckpt import load_checkpoint, load_meta
from ..utils.device import resolve_device
from ..utils.jsonl import append_record
from .common import (
    add_common_args,
    as_rgb,
    checkpoint_spec,
    config_for,
    load_sample_dir,
    provenance_row,
    reference_images,
    vq_decode_fn_for,
)
from .generate_samples import batch_generator


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--load", type=str, default=None, help="model dir")
    parser.add_argument("--sample_dir", type=str, default=None,
                        help="precomputed sample dir instead of a model")
    parser.add_argument("--n_samples", type=int, default=1024)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--inception_weights", type=str, default=None)
    parser.add_argument("--ref_stats", type=str, default=None,
                        help="cached reference stats .pkl (used when its tower tag "
                             "matches, else computed and saved)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--skip_pr", action="store_true", default=False)
    parser.add_argument("--pr_extractor", type=str, default="inception",
                        choices=["inception", "vgg16"],
                        help="P&R feature tower; 'vgg16' matches the reference's "
                             "StyleGAN2 VGG16 features")
    parser.add_argument("--vgg16_weights", type=str, default=None,
                        help="torchvision-style vgg16 state dict for --pr_extractor vgg16")
    parser.add_argument("--pr_vgg_tiny", action="store_true", default=False,
                        help="narrow VGG tower for smoke tests")
    parser.add_argument("--per_class", action="store_true", default=False,
                        help="average FID over class subdirs of --sample_dir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def _per_class_fid(sample_dir: str, extract, ref_by_class) -> float:
    """Average FID over class subdirectories: sample_dir/<class>/ against the
    reference images of that class."""
    fids = []
    for cls in sorted(os.listdir(sample_dir)):
        cls_dir = os.path.join(sample_dir, cls)
        if not os.path.isdir(cls_dir) or cls not in ref_by_class:
            continue
        gen_feats, _ = extract(load_sample_dir(cls_dir))
        ref_feats, _ = extract(ref_by_class[cls])
        fids.append(calculate_fid_from_features(gen_feats, ref_features=ref_feats))
    if not fids:
        raise SystemExit(f"no class subdirectories found under {sample_dir}")
    return float(np.mean(fids))


def _sample_checkpoint(args, cfg, device) -> tuple:
    """(samples (n, H, W, C) in [0, 1], remaining_idx, removed_idx): DDIM
    samples of the checkpoint's EMA weights, batch b drawn from (seed, b)."""
    spec = checkpoint_spec(args.load, cfg.unet)
    model = UNet2D(spec)
    model.load_state_dict(load_checkpoint(args.load)["ema_params"])
    model.to(device).eval()
    meta = load_meta(args.load)
    batch = min(args.batch_size, args.n_samples)
    sampler = make_sampler(model, cfg.scheduler,
                           (batch, spec.in_channels, spec.sample_size, spec.sample_size),
                           device=device, num_inference_steps=args.num_inference_steps,
                           decode_fn=vq_decode_fn_for(cfg, args.vqvae_weights, device=device))
    chunks = [sampler(generator=batch_generator(args.seed, b, device)).cpu()
              for b in range(-(-args.n_samples // batch))]
    samples = torch.cat(chunks)[:args.n_samples].permute(0, 2, 3, 1).numpy()
    return samples, meta.get("remaining_idx", []), meta.get("removed_idx", [])


def main(argv=None):
    """Run the CLI; returns the JSONL row written, with the samples scored
    (None with --per_class) under "samples"."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_for(args.dataset)
    db = args.db or os.path.join(args.outdir, f"{args.dataset}_global_db.jsonl")
    extract = make_feature_fn(load_inception(args.inception_weights, device=device),
                              batch_size=args.batch_size)

    if args.per_class:
        if not args.sample_dir:
            raise SystemExit("--per_class needs --sample_dir with class subdirs")
        ref = create_dataset(args.dataset, train=True, device=device)
        ref_imgs = reference_images(ref, len(ref))
        ref_by_class = {str(c): ref_imgs[ref.labels == c] for c in np.unique(ref.labels)}
        t0 = time.time()
        fid_value = _per_class_fid(args.sample_dir, extract, ref_by_class)
        row = provenance_row(args, fid_value=fid_value, scoring_time=time.time() - t0)
        append_record(db, row)
        print(f"per-class avg fid={fid_value:.3f} -> {db}")
        return dict(row, samples=None)

    t0 = time.time()
    if args.sample_dir:
        samples = load_sample_dir(args.sample_dir)
        remaining_idx, removed_idx = [], []
    elif args.load:
        samples, remaining_idx, removed_idx = _sample_checkpoint(args, cfg, device)
    else:
        raise SystemExit("need --load or --sample_dir")
    sampling_time = time.time() - t0
    samples = as_rgb(samples)

    t0 = time.time()
    gen_feats, gen_logits = extract(samples)
    ref = create_dataset(args.dataset, train=True, device=device)
    n_ref = max(args.n_samples, 2048)
    tag = inception_tag(args.inception_weights)
    ref_feats = None
    ref_stats = load_reference_stats(args.ref_stats, tag)
    if ref_stats is None:
        ref_feats, _ = extract(reference_images(ref, n_ref))
        ref_stats = compute_feature_stats(ref_feats)
        if args.ref_stats:
            save_stats(args.ref_stats, *ref_stats, tower=tag)
    tower_time = time.time() - t0

    t0 = time.time()
    fid_value = calculate_fid_from_features(gen_feats, ref_stats=ref_stats)
    fid_time = time.time() - t0
    is_mean, is_std = inception_score_from_logits(gen_logits)
    t0 = time.time()
    if args.skip_pr or (ref_feats is None and args.pr_extractor == "inception"):
        precision = recall = None
    elif args.pr_extractor == "vgg16":
        # P&R on VGG16 fc2 features, apart from the FID/IS tower.
        vgg_extract = make_vgg_feature_fn(
            load_vgg16(args.vgg16_weights, tiny=args.pr_vgg_tiny, device=device),
            batch_size=args.batch_size)
        precision, recall = compute_precision_recall(
            vgg_extract(reference_images(ref, n_ref)), vgg_extract(samples), device=device)
    else:
        precision, recall = compute_precision_recall(ref_feats, gen_feats, device=device)
    pr_time = time.time() - t0

    row = provenance_row(
        args,
        fid_value=fid_value,
        **{"is": is_mean},
        is_std=is_std,
        precision=precision,
        recall=recall,
        remaining_idx=list(remaining_idx),
        removed_idx=list(removed_idx),
        sampling_time=sampling_time,
        scoring_time=tower_time + fid_time + pr_time,
    )
    append_record(db, row)
    print(f"fid={fid_value:.3f} is={is_mean:.3f}+-{is_std:.3f} precision={precision} "
          f"recall={recall} -> {db} (sampling {sampling_time:.2f}s, tower {tower_time:.2f}s, "
          f"FID math {fid_time:.2f}s, P&R {pr_time:.2f}s)")
    return dict(row, samples=samples)


if __name__ == "__main__":
    main()
