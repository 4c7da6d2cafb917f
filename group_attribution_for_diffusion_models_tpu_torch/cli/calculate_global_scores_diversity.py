"""Demographic-diversity entropy of one model (the CelebA global behavior).

Port of the JAX package's ``cli/calculate_global_scores_diversity.py``:
embed reference and generated images, Ward-cluster the reference embeddings
into ``--num_clusters``, assign the generated images to the nearest clusters
and append one JSONL row with entropy, cluster_count and
cluster_proportions (the keys ``cli.lds --behavior entropy`` reads) and the
checkpoint's remaining_idx/removed_idx.

Embeddings come from, in order: ``--embeddings_npz`` (precomputed
``ref_emb``, and ``gen_emb`` if it has one); else ``--n_samples`` DDIM
samples of ``--load``'s EMA weights (decoded by the VQ-VAE on latent
workloads) and the first 4 x n_samples training images, embedded by the BLIP
vision tower (``--blip_weights`` / ``--blip_tiny``, the reference's
extractor) or by the InceptionV3 pool3 tower (``--inception_weights``,
seeded random without). Runs on CUDA unless ``--device cpu`` is given; on
CUDA, TF32 is off.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..attributions.global_scores import (
    calculate_diversity_score,
    load_inception,
    make_feature_fn,
)
from ..data import create_dataset
from ..diffusion.sampling import make_sampler
from ..models.blip_vision import load_blip_vision, make_blip_feature_fn
from ..models.unet2d import empty_unet
from ..utils.ckpt import load_checkpoint, load_meta
from ..utils.device import resolve_device
from ..utils.jsonl import append_record
from .common import (
    add_common_args,
    as_rgb,
    checkpoint_spec,
    config_for,
    provenance_row,
    reference_images,
    vq_decode_fn_for,
)
from .generate_samples import batch_generator


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--load", type=str, default=None, help="model dir")
    parser.add_argument("--embeddings_npz", type=str, default=None,
                        help="npz with ref_emb (and optionally gen_emb)")
    parser.add_argument("--n_samples", type=int, default=256)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_clusters", type=int, default=20)
    parser.add_argument("--inception_weights", type=str, default=None)
    parser.add_argument("--blip_weights", type=str, default=None,
                        help="BLIP vision-tower weights (a JAX .npy tree or an HF "
                             "BlipVisionModel state dict): embed with the reference's "
                             "BLIP-VQA extractor instead of Inception")
    parser.add_argument("--blip_tiny", action="store_true", default=False,
                        help="tiny BLIP tower (smoke tests)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def _sample(args, cfg, device) -> np.ndarray:
    """(n, H, W, C) DDIM samples in [0, 1] of the checkpoint's EMA weights,
    batch b drawn from (seed, b)."""
    spec = checkpoint_spec(args.load, cfg.unet)
    model = empty_unet(spec)
    model.load_state_dict(load_checkpoint(args.load)["ema_params"])
    model.to(device).eval()
    batch = min(args.batch_size, args.n_samples)
    sampler = make_sampler(model, cfg.scheduler,
                           (batch, spec.in_channels, spec.sample_size, spec.sample_size),
                           device=device, num_inference_steps=args.num_inference_steps, kind="ddim",
                           decode_fn=vq_decode_fn_for(cfg, args.vqvae_weights, device=device))
    chunks = [sampler(generator=batch_generator(args.seed, b, device)).cpu()
              for b in range(-(-args.n_samples // batch))]
    return torch.cat(chunks)[:args.n_samples].permute(0, 2, 3, 1).numpy()


def main(argv=None):
    """Run the CLI; returns the JSONL row written, with the seconds of
    sampling, of the embedding tower (generated and reference images) and
    of the clustering under "seconds"."""
    args = parse_args(argv)
    cfg = config_for(args.dataset)
    ref_emb = gen_emb = None
    if args.embeddings_npz:
        store = np.load(args.embeddings_npz)
        ref_emb = store["ref_emb"]
        gen_emb = store.get("gen_emb")

    remaining_idx, removed_idx = [], []
    seconds = {"sampling": 0.0, "tower": 0.0, "clustering": 0.0}
    if gen_emb is None:
        if not args.load:
            raise SystemExit("need --load (or gen_emb inside --embeddings_npz)")
        device = resolve_device(args.device)
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        meta = load_meta(args.load)
        remaining_idx = meta.get("remaining_idx", [])
        removed_idx = meta.get("removed_idx", [])
        t0 = time.perf_counter()
        samples = as_rgb(_sample(args, cfg, device))
        seconds["sampling"] = time.perf_counter() - t0

        # Embedding tower: BLIP-VQA (the reference's extractor) when asked
        # for, InceptionV3 pool3 otherwise.
        t0 = time.perf_counter()
        if args.blip_weights or args.blip_tiny:
            extract = make_blip_feature_fn(
                load_blip_vision(args.blip_weights, tiny=args.blip_tiny, device=device),
                batch_size=args.batch_size)
        else:
            pool3 = make_feature_fn(load_inception(args.inception_weights, device=device),
                                    batch_size=args.batch_size)

            def extract(images):
                return pool3(images)[0]
        gen_emb = extract(samples)
        if ref_emb is None:
            ref = create_dataset(args.dataset, train=True, device=device)
            ref_emb = extract(reference_images(ref, 4 * args.n_samples))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds["tower"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = calculate_diversity_score(ref_emb, gen_emb, args.num_clusters)
    seconds["clustering"] = time.perf_counter() - t0
    row = provenance_row(
        args,
        entropy=out["entropy"],
        cluster_count=out["cluster_count"],
        cluster_proportions=out["cluster_proportions"],
        remaining_idx=list(remaining_idx),
        removed_idx=list(removed_idx),
        sampling_time=seconds["sampling"],
    )
    db = args.db or os.path.join(args.outdir, f"{args.dataset}_diversity_db.jsonl")
    append_record(db, row)
    print(f"entropy={out['entropy']:.4f} clusters={args.num_clusters} counts "
          f"{[int(c) for c in out['cluster_count']]} -> {db} (sampling "
          f"{seconds['sampling']:.2f}s, tower {seconds['tower']:.2f}s, clustering "
          f"{seconds['clustering']:.3f}s)")
    return dict(row, seconds=seconds)


if __name__ == "__main__":
    main()
