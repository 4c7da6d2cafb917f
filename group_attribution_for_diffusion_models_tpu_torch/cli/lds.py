"""LDS evaluation of attribution methods from JSONL behavior databases.

Port of the JAX package's ``cli/lds.py``: collect (mask, behavior) rows from
a train DB filtered by condition, fit the attribution that matches the
removal distribution (shapley -> closed-form KernelSHAP, uniform -> Banzhaf,
datamodel -> ridge-CV, loo/aoi -> difference sums), then report Spearman LDS
x100 against held-out datamodel-retrain test DBs with a 1.96-SE interval,
across growing train sizes, with optional bootstrap intervals. The fits are
numpy on the host; ``--device`` (default cuda) is the port's entry-point
contract, so a run without CUDA asks for ``--device cpu``.

Usage (CPU):
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.lds \\
        --dataset synthetic_64x8 --removal_dist shapley --train_db db.jsonl \\
        --test_db db.jsonl --model_behavior_key eval_loss --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ..attributions import bootstrap_lds_ci, collect_data, collect_local_data, evaluate_lds
from ..attributions.methods import data_banzhaf, data_shapley, datamodel
from ..data import create_dataset
from ..utils.device import resolve_device
from ..utils.jsonl import filter_records
from .common import add_common_args


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--train_db", type=str, required=True)
    parser.add_argument("--test_db", type=str, nargs="+", required=True)
    parser.add_argument("--method", type=str, default="retrain")
    parser.add_argument("--test_exp_name", type=str, default=None)
    parser.add_argument(
        "--model_behavior_key", type=str, default="fid_value",
        choices=["is", "fid_value", "entropy", "mse", "nrmse", "ssim",
                 "diffusion_loss", "precision", "recall", "avg_mse", "avg_ssim",
                 "avg_nrmse", "avg_total_loss", "loss", "eval_loss",
                 "aesthetic_score_avg", "clip_prompt_score_avg"],
    )
    parser.add_argument("--num_units", type=int, default=None,
                        help="mask dimension (default: dataset size)")
    parser.add_argument("--n_samples", type=int, default=None,
                        help="per-image local-behavior mode: use "
                             "generated_image_{i}_<key> columns as separate behaviors")
    parser.add_argument("--max_train_size", type=int, default=None)
    parser.add_argument("--train_size_step", type=int, default=100)
    parser.add_argument("--v1", type=float, default=None,
                        help="full-model behavior (shapley efficiency anchor)")
    parser.add_argument("--v0", type=float, default=None,
                        help="null-model behavior (shapley efficiency anchor)")
    parser.add_argument("--full_db", type=str, default=None,
                        help="JSONL with the full-model behavior row (overrides --v1)")
    parser.add_argument("--null_db", type=str, default=None,
                        help="JSONL with the null-model behavior row (overrides --v0)")
    parser.add_argument("--num_runs", type=int, default=1,
                        help="datamodel bootstrap count")
    parser.add_argument("--bootstrapped", action="store_true", default=False)
    parser.add_argument("--num_bootstrap_iters", type=int, default=100)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the entry point; the fits are numpy")
    return parser.parse_args(argv)


def fit_attribution(
    removal_dist: str,
    masks: np.ndarray,
    behaviors: np.ndarray,
    num_units: int,
    v1=None,
    v0=None,
    num_runs: int = 1,
):
    """The estimator of each removal distribution. The *_paired antithetic
    variants have their base distributions' marginals, so they fit with the
    same estimator."""
    if removal_dist in ("shapley", "shapley_paired"):
        v1 = float(v1 if v1 is not None else behaviors.max())
        v0 = float(v0 if v0 is not None else behaviors.min())
        return data_shapley(num_units, masks, behaviors, v1, v0).ravel()
    if removal_dist in ("uniform", "uniform_paired"):
        return data_banzhaf(masks, behaviors).ravel()
    if removal_dist == "datamodel":
        return datamodel(masks, behaviors, num_runs=num_runs).mean(axis=0)
    if removal_dist in ("loo", "aoi"):
        # Sum of behavior deltas attributed to the single flipped unit.
        attrs = np.zeros(num_units)
        base = behaviors.mean()
        for mask, y in zip(masks, behaviors):
            loo = removal_dist == "loo"
            target = np.flatnonzero(mask == 0) if loo else np.flatnonzero(mask == 1)
            if len(target) == 1:
                attrs[target[0]] += base - y if loo else y - base
        return attrs
    raise ValueError(f"unknown removal_dist {removal_dist!r}")


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    if args.num_units is None:
        dataset = create_dataset(args.dataset, train=True, device=args.device)
        if args.by_class:
            num_units = int(len(np.unique(dataset.labels)))
            labels = dataset.labels
        else:
            num_units = len(dataset)
            labels = None
    else:
        num_units, labels = args.num_units, None

    cond = {"dataset": args.dataset, "method": args.method,
            "removal_dist": args.removal_dist}
    if args.exp_name:
        cond["exp_name"] = args.exp_name

    def collect(db, c):
        if args.n_samples:
            return collect_local_data(
                db, c, num_units, args.model_behavior_key, args.n_samples,
                by_class=args.by_class, labels=labels,
            )
        m, y, s = collect_data(
            db, c, num_units, args.model_behavior_key,
            by_class=args.by_class, labels=labels,
        )
        return m, y.reshape(-1, 1), s

    # Shapley efficiency anchors from dedicated full/null DBs: sum(attrs)
    # must equal v1 - v0, which for loss-like behaviors is negative, so
    # max/min anchors would flip the constraint.
    def _db_value(path):
        for rec in filter_records(path, {"dataset": args.dataset}):
            v = rec.get(args.model_behavior_key)
            if v is not None:
                return float(v)
        raise SystemExit(
            f"no {args.model_behavior_key} row for {args.dataset} in {path}"
        )

    if args.full_db:
        args.v1 = _db_value(args.full_db)
    if args.null_db:
        args.v0 = _db_value(args.null_db)

    masks, behaviors, _ = collect(args.train_db, cond)
    if len(masks) == 0:
        raise SystemExit(f"no rows matched {cond} in {args.train_db}")
    num_behaviors = behaviors.shape[1]
    print(f"{len(masks)} fit subsets x {num_behaviors} behaviors "
          f"from {args.train_db}")

    test_cond = {"dataset": args.dataset, "removal_dist": "datamodel",
                 "method": "retrain"}
    if args.test_exp_name:
        test_cond["exp_name"] = args.test_exp_name
    test_data = []
    for db in args.test_db:
        x, y, _ = collect(db, test_cond)
        if len(x):
            test_data.append((x, y))
    if not test_data:
        raise SystemExit("no test rows found")

    max_n = args.max_train_size or len(masks)
    sizes = list(range(args.train_size_step, max_n + 1, args.train_size_step))
    if not sizes or sizes[-1] != max_n:
        sizes.append(max_n)
    results = []
    for n in sizes:
        attrs_all = np.stack([
            fit_attribution(
                args.removal_dist, masks[:n], behaviors[:n, k], num_units,
                v1=args.v1, v0=args.v0, num_runs=args.num_runs,
            )
            for k in range(num_behaviors)
        ])
        lds_mean, lds_ci = evaluate_lds(
            attrs_all, test_data, num_model_behaviors=num_behaviors
        )
        line = f"train_size={n} LDS={lds_mean:.2f} +- {lds_ci:.2f}"
        result = {"train_size": n, "lds_mean": lds_mean, "lds_ci": lds_ci}
        if args.bootstrapped and num_behaviors == 1:
            x_all = np.concatenate([x for x, _ in test_data])
            y_all = np.concatenate([y[:, 0] for _, y in test_data])
            bmean, blo, bhi = bootstrap_lds_ci(
                attrs_all[0], x_all, y_all, args.num_bootstrap_iters
            )
            line += f" bootstrap=[{blo:.2f}, {bhi:.2f}]"
            result.update(bootstrap_mean=bmean, bootstrap_low=blo, bootstrap_high=bhi)
        results.append(result)
        print(line, flush=True)
    return results


if __name__ == "__main__":
    main()
