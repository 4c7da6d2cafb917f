"""Empirical verification that sparse fine-tuning approximates retraining.

Port of the JAX package's ``cli/empirical_verification.py`` (reference
notebooks/empirical_verification.ipynb and
sparsified_ft_approximation.ipynb): for subsets scored by both the baseline
method (retrain) and the efficient method (sparse-FT / gd), the Pearson and
Spearman correlation of their behaviors, matched by removal seed, the
fidelity number behind the paper's "sFT ~= retrain" claim; with
``--attributions``, also the correlation of the KernelSHAP attribution
vectors fit from each method's rows. Host numpy and scipy; ``--device`` runs
only the ResNet-18 of a cifar100_new regroup.
"""

from __future__ import annotations

import argparse

import numpy as np
from scipy.stats import pearsonr, spearmanr

from ..attributions import collect_data
from ..attributions.methods import data_shapley
from ..data import create_dataset
from ..utils.jsonl import filter_records


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--db", type=str, required=True)
    parser.add_argument("--baseline_method", type=str, default="retrain")
    parser.add_argument("--method", type=str, default="prune_fine_tune")
    parser.add_argument("--removal_dist", type=str, default="shapley")
    parser.add_argument("--model_behavior_key", type=str, default="fid_value")
    parser.add_argument("--attributions", action="store_true",
                        help="also fit kernel-SHAP attributions from each method's rows "
                             "and report the correlation of the two attribution vectors")
    parser.add_argument("--dataset", type=str, default=None,
                        help="needed with --attributions to size the units")
    parser.add_argument("--by_class", action="store_true")
    parser.add_argument("--v1", type=float, default=None,
                        help="full-model behavior (shapley efficiency anchor); defaults "
                             "to behaviors.max()")
    parser.add_argument("--v0", type=float, default=None,
                        help="null-model behavior anchor (see --v1)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the ResNet-18 that regroups cifar100_new "
                             "when its group labels are not cached")
    return parser.parse_args(argv)


def _attribution_vector(db, cond, num_units, key, by_class, labels, v1, v0):
    masks, behaviors, _ = collect_data(db, cond, num_units, key, by_class=by_class,
                                       labels=labels)
    if len(masks) < num_units + 2:
        raise SystemExit(
            f"--attributions: {cond} has {len(masks)} rows; need at least "
            f"num_units+2 = {num_units + 2} for a determined kernel-SHAP fit"
        )
    v1 = float(behaviors.max() if v1 is None else v1)
    v0 = float(behaviors.min() if v0 is None else v0)
    return data_shapley(num_units, masks, behaviors, v1, v0).ravel()


def main(argv=None):
    """Run the CLI; returns {"seeds", "pearson", "spearman", "mse"} of the
    behaviors and, with --attributions, "attr_pearson", "attr_spearman"."""
    args = parse_args(argv)

    def seed_map(method):
        rows = filter_records(args.db, {"method": method, "removal_dist": args.removal_dist})
        return {
            int(r["removal_seed"]): float(r[args.model_behavior_key])
            for r in rows
            if r.get(args.model_behavior_key) is not None
            and r.get("removal_seed") is not None
        }

    base = seed_map(args.baseline_method)
    meth = seed_map(args.method)
    shared = sorted(set(base) & set(meth))
    if len(shared) < 3:
        raise SystemExit(
            f"need >=3 shared removal seeds; found {len(shared)} "
            f"(baseline {len(base)}, method {len(meth)})"
        )
    a = np.asarray([base[s] for s in shared])
    b = np.asarray([meth[s] for s in shared])
    out = {"seeds": shared, "pearson": float(pearsonr(a, b).statistic),
           "spearman": float(spearmanr(a, b).statistic), "mse": float(np.mean((a - b) ** 2))}
    print(
        f"{args.method} vs {args.baseline_method} on "
        f"{args.model_behavior_key} ({len(shared)} seeds): "
        f"pearson={out['pearson']:.4f} spearman={out['spearman']:.4f} mse={out['mse']:.6f}"
    )

    if args.attributions:
        if args.dataset is None:
            raise SystemExit("--attributions requires --dataset")
        dataset = create_dataset(args.dataset, train=True, device=args.device)
        if args.by_class:
            num_units, labels = dataset.num_classes, dataset.labels
        else:
            num_units, labels = len(dataset), None
        va, vb = (
            _attribution_vector(args.db, {"method": m, "removal_dist": args.removal_dist},
                                num_units, args.model_behavior_key, args.by_class, labels,
                                args.v1, args.v0)
            for m in (args.baseline_method, args.method)
        )
        out.update(attr_pearson=float(pearsonr(va, vb).statistic),
                   attr_spearman=float(spearmanr(va, vb).statistic))
        print(
            f"attribution vectors ({num_units} units): "
            f"pearson={out['attr_pearson']:.4f} spearman={out['attr_spearman']:.4f}"
        )
    return out


if __name__ == "__main__":
    main()
