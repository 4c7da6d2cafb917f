"""Assemble TRAK-family attributions from saved gradient-feature stores.

Port of the JAX package's ``cli/traks.py`` (numpy only, the same flags and
outputs): load projected gradient features for train and generated images
(from ``cli.grad_features``), invert the regularized kernel, assemble
grad-sim / TRAK / relative-IF / renormalized-IF scores, aggregate per group
(sum, mean or max), and save ``attrs_<method>.npy`` and
``ranking_<method>.npy``. `main` returns {method: attributions}.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..attributions.methods.trak import aggregate_by_group, compute_gradient_scores

METHODS = ("grad_sim", "trak", "relative_if", "renormalized_if")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--feature_store", type=str, required=True,
                        help=".npz with train_features, gen_features, group_labels")
    parser.add_argument("--methods", type=str, nargs="+", default=list(METHODS))
    parser.add_argument("--lambda_reg", type=float, default=5e-1)
    parser.add_argument("--agg_mode", type=str, default="sum",
                        choices=["sum", "mean", "max"])
    parser.add_argument("--save_dir", type=str, required=True)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    store = np.load(args.feature_store)
    train = store["train_features"]
    gen = store["gen_features"]
    labels = store["group_labels"] if "group_labels" in store else None

    os.makedirs(args.save_dir, exist_ok=True)
    out = {}
    for method in args.methods:
        scores = compute_gradient_scores(train, gen, method, args.lambda_reg)
        attrs = (
            aggregate_by_group(scores, labels, args.agg_mode)
            if labels is not None
            else scores.mean(axis=1)
        )
        np.save(os.path.join(args.save_dir, f"attrs_{method}.npy"), attrs)
        np.save(
            os.path.join(args.save_dir, f"ranking_{method}.npy"),
            np.argsort(attrs)[::-1],
        )
        print(f"{method}: {len(attrs)} attributions -> {args.save_dir}")
        out[method] = attrs
    return out


if __name__ == "__main__":
    main()
