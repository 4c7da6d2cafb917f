"""Shapley-estimate convergence vs pseudo-ground-truth.

Port of the JAX package's ``cli/shapley_convergence.py`` (reference
text_to_image/shapley_convergence.py:240-268): fit Shapley attributions
from the baseline (retrain) rows and from the efficient method's
(sparse_gd) rows at growing fit sizes, and report MSE / Pearson / Spearman
between the method's estimates and the baseline pseudo-ground-truth.
`main` returns each fit size's metrics.
"""

from ._tti_lds import base_parser, collect_group_data, convergence_metrics, shapley_fit


def main(argv=None):
    parser = base_parser(__doc__)
    parser.add_argument("--baseline_method", type=str, default="retrain")
    args = parser.parse_args(argv)
    fit = shapley_fit(args)

    base_masks, base_y, _ = collect_group_data(
        args.train_db,
        {"removal_dist": "shapley", "method": args.baseline_method},
        args.num_groups, args.model_behavior_key,
    )
    meth_masks, meth_y, _ = collect_group_data(
        args.train_db,
        {"removal_dist": "shapley", "method": args.method},
        args.num_groups, args.model_behavior_key,
    )
    if len(base_masks) == 0 or len(meth_masks) == 0:
        raise SystemExit("missing baseline or method rows")

    truth = fit(base_masks, base_y)
    max_n = args.max_train_size or len(meth_masks)
    sizes = list(range(args.train_size_step, max_n, args.train_size_step)) + [max_n]
    out = {}
    for n in sizes:
        est = fit(meth_masks[:n], meth_y[:n])
        m = out[n] = convergence_metrics(est, truth)
        print(
            f"fit_size={n} mse={m['mse']:.6f} pearson={m['pearson']:.4f} "
            f"spearman={m['spearman']:.4f}",
            flush=True,
        )
    return out


if __name__ == "__main__":
    main()
