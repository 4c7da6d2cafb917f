"""Retraining-free similarity baselines: pixel / CLIP-embedding / aesthetic.

Port of the JAX package's ``cli/similarity_baselines.py`` (reference
text_to_image/{baselines,pixel_similarity,clip_similarity,
aesthetic_score}.py): similarity matrices between generated images and
training images (raw-pixel cosine, CLIP-embedding cosine), or per-training-
image aesthetic scores, aggregated per group (max/avg over generations, then
sum/mean/max per group), saved as an attribution vector and its ranking.
The same flags as the JAX CLI plus ``--device``; runs on CUDA unless
``--device cpu`` is given. `main` returns the attributions.

The groups of an ArtBench-style folder (file names ``<artist>_<title>_
<year>``) are its artists, in sorted order, as `cli.grad_features_tti` and
the LoRA trainer number them; elsewhere they are the dataset's labels. The JAX
CLI always takes the labels, which put every image of such a folder in one
group (ROADMAP C4).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..attributions.methods.similarity import (
    aggregate_by_class,
    embedding_similarity_scores,
    pixel_distance_scores,
)
from ..data import create_dataset
from ..data.groups import artist_from_filename
from ..models.clip_vision import load_aesthetic_head, load_clip_vision, make_embed_fn
from ..utils.device import resolve_device
from .common import load_sample_dir


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--baseline", type=str, default="pixel",
                        choices=["pixel", "clip", "aesthetic"])
    parser.add_argument("--generated_dir", type=str, default=None,
                        help="dir of generated images (pixel/clip need it)")
    parser.add_argument("--by", type=str, default="max", choices=["max", "avg"])
    parser.add_argument("--agg", type=str, default="mean",
                        choices=["sum", "mean", "max"])
    parser.add_argument("--clip_weights", type=str, default=None)
    parser.add_argument("--aesthetic_weights", type=str, default=None)
    parser.add_argument("--max_examples", type=int, default=None)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> np.ndarray:
    args = parse_args(argv)
    device = resolve_device(args.device)
    tiny = args.dataset.startswith("synthetic")
    train = create_dataset(args.dataset, train=True, device=device)
    train_imgs = train.images / 2.0 + 0.5
    labels = train.labels
    if train.names is not None and all(
            os.path.basename(f).count("_") >= 2 for f in train.names):
        units = sorted({artist_from_filename(f) for f in train.names})
        labels = np.asarray([units.index(artist_from_filename(f)) for f in train.names])
    if args.max_examples:
        train_imgs, labels = train_imgs[: args.max_examples], labels[: args.max_examples]

    if args.baseline == "aesthetic":
        emb = make_embed_fn(load_clip_vision(args.clip_weights, tiny, device))(
            train_imgs[..., :3])
        head = load_aesthetic_head(args.aesthetic_weights, dim=emb.shape[1], device=device)
        with torch.no_grad():
            scores_per_train = head(torch.from_numpy(emb).to(device)).cpu().numpy()
        groups = np.unique(labels)
        attrs = np.array([
            scores_per_train[labels == g].max() if args.by == "max"
            else scores_per_train[labels == g].mean()
            for g in groups
        ])
    else:
        if not args.generated_dir:
            raise SystemExit(f"--baseline {args.baseline} needs --generated_dir")
        gen_imgs = load_sample_dir(args.generated_dir)
        if args.baseline == "pixel":
            # Match channel counts for raw-pixel cosine.
            c = min(gen_imgs.shape[-1], train_imgs.shape[-1])
            scores = pixel_distance_scores(gen_imgs[..., :c], train_imgs[..., :c], device)
        else:
            embed = make_embed_fn(load_clip_vision(args.clip_weights, tiny, device))
            scores = embedding_similarity_scores(embed(gen_imgs[..., :3]),
                                                 embed(train_imgs[..., :3]), device)
        attrs = aggregate_by_class(scores, labels, agg=args.agg, by=args.by)

    os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
    np.save(args.save_path, attrs)
    np.save(args.save_path.replace(".npy", "") + "_ranking.npy", np.argsort(attrs)[::-1])
    print(f"{args.baseline}: {len(attrs)} group attributions -> {args.save_path}")
    return attrs


if __name__ == "__main__":
    main()
