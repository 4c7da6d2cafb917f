"""Unified attribution entry over a model-behavior database.

Port of the JAX package's ``cli/attribute.py`` (reference
unconditional_generation/attribute.py:129-183): fit shapley / datamodel /
banzhaf attributions from JSONL behavior rows, or score gradient features
(d_trak, trak, relative_if, renormalized_if, grad_sim: a feature store
``.npz`` with ``train_features``, ``gen_features`` and optionally
``group_labels``), or read the saved similarity attributions (clip_score,
pixel_dist: the ``.npy`` that ``cli.similarity_baselines`` writes with
``--baseline clip`` / ``pixel``), and save the per-unit attribution vector
and its ranking as .npy. Host numpy; ``--device`` runs only the ResNet-18
of a cifar100_new regroup.

The JAX CLI offers clip_score and pixel_dist but has no branch for them (a
KeyError); the port reads them from the saved scores (ROADMAP C4).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..attributions import collect_data
from ..attributions.methods import data_banzhaf, data_shapley, datamodel
from ..attributions.methods.trak import aggregate_by_group, compute_gradient_scores
from ..data import create_dataset
from .common import add_common_args

GRADIENT_METHODS = ("d_trak", "trak", "relative_if", "renormalized_if", "grad_sim")
SAVED_METHODS = ("clip_score", "pixel_dist")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--attribution_method", type=str, default="shapley",
                        choices=["shapley", "datamodel", "banzhaf", *GRADIENT_METHODS,
                                 *SAVED_METHODS])
    parser.add_argument("--train_db", type=str, required=True,
                        help="behavior DB; feature .npz for the trak family; attribution "
                             ".npy for clip_score / pixel_dist")
    parser.add_argument("--model_behavior_key", type=str, default="fid_value")
    parser.add_argument("--method", type=str, default="retrain")
    parser.add_argument("--num_units", type=int, default=None)
    parser.add_argument("--v1", type=float, default=None)
    parser.add_argument("--v0", type=float, default=None)
    parser.add_argument("--num_runs", type=int, default=1)
    parser.add_argument("--lambda_reg", type=float, default=5e-1)
    parser.add_argument("--agg_mode", type=str, default="sum",
                        choices=["sum", "mean", "max"])
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the ResNet-18 that regroups cifar100_new "
                             "when its group labels are not cached")
    return parser.parse_args(argv)


def fit_from_rows(args) -> np.ndarray:
    """shapley / banzhaf / datamodel attributions from the DB's rows of
    (``--dataset``, ``--method``[, ``--exp_name``]); the *_paired rows pool
    with their base distribution."""
    if args.num_units is None:
        dataset = create_dataset(args.dataset, train=True, device=args.device)
        num_units = dataset.num_classes if args.by_class else len(dataset)
        labels = dataset.labels if args.by_class else None
    else:
        num_units, labels = args.num_units, None
    cond = {"dataset": args.dataset, "method": args.method}
    if args.exp_name:
        cond["exp_name"] = args.exp_name
    dists = {
        "shapley": ("shapley", "shapley_paired"),
        "banzhaf": ("uniform", "uniform_paired"),
        "datamodel": ("datamodel",),
    }[args.attribution_method]
    parts = [
        collect_data(args.train_db, {**cond, "removal_dist": d}, num_units,
                     args.model_behavior_key, by_class=args.by_class, labels=labels)
        for d in dists
    ]
    masks = np.concatenate([p[0] for p in parts], axis=0)
    behaviors = np.concatenate([p[1] for p in parts], axis=0)
    if len(masks) == 0:
        raise SystemExit(f"no rows matched {cond} in {args.train_db}")
    if args.attribution_method == "shapley":
        v1 = float(args.v1 if args.v1 is not None else behaviors.max())
        v0 = float(args.v0 if args.v0 is not None else behaviors.min())
        return data_shapley(num_units, masks, behaviors, v1, v0).ravel()
    if args.attribution_method == "banzhaf":
        return data_banzhaf(masks, behaviors).ravel()
    return datamodel(masks, behaviors, num_runs=args.num_runs).mean(axis=0)


def main(argv=None):
    """Run the CLI; returns the attribution vector."""
    args = parse_args(argv)
    if args.attribution_method in GRADIENT_METHODS:
        store = np.load(args.train_db)
        method = "trak" if args.attribution_method == "d_trak" else args.attribution_method
        scores = compute_gradient_scores(store["train_features"], store["gen_features"],
                                         method, lambda_reg=args.lambda_reg)
        if "group_labels" in store:
            attrs = aggregate_by_group(scores, store["group_labels"], args.agg_mode)
        else:
            attrs = scores.mean(axis=1)
    elif args.attribution_method in SAVED_METHODS:
        attrs = np.asarray(np.load(args.train_db), np.float64).ravel()
    else:
        attrs = fit_from_rows(args)

    os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
    np.save(args.save_path, attrs)
    ranking = np.argsort(attrs)[::-1]
    np.save(args.save_path.replace(".npy", "") + "_ranking.npy", ranking)
    print(
        f"{args.attribution_method}: {len(attrs)} attributions -> {args.save_path}; "
        f"top-5 units {ranking[:5].tolist()}"
    )
    return attrs


if __name__ == "__main__":
    main()
