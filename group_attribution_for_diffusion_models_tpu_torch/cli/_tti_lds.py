"""Shared engine of the text-to-image LDS family.

Port of the JAX package's ``cli/_tti_lds.py``, behind the thin CLIs
``shapley_lds``, ``banzhaf_lds``, ``loo_lds``, ``aoi_lds``,
``shapley_convergence`` and ``baseline_lds`` (reference text_to_image/
{shapley_lds, banzhaf_lds, loo_lds, aoi_lds, shapley_convergence,
baseline_lds}.py): collect (group-mask, behavior) rows from JSONL DBs (masks
over the artist groups: a row's ``kept_units``, as the LoRA trainer writes
them, or the removal redrawn from its ``removal_dist`` and
``removal_seed``, as a ``compute_model_behaviors`` row needs), fit the
distribution's estimator at growing train sizes, and score Spearman LDS
against datamodel-retrain test DBs (seeds 42/43/44 convention, reference
shapley_lds.py:158-166). numpy and scipy over the DB, with the port's
`filter_records`, `data_shapley`, `evaluate_lds` and `sample_removal`; the
printed lines and saved arrays are the JAX CLIs'.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np
from scipy.stats import pearsonr, spearmanr

from ..attributions import evaluate_lds
from ..attributions.methods import data_shapley
from ..data.removal import sample_removal
from ..utils.jsonl import filter_records, read_records


def collect_group_data(
    db_path: str,
    condition: dict,
    num_groups: int,
    behavior_key: str,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(masks over groups, behaviors, seeds) from a LoRA/behavior DB.

    Masks come from `kept_units` (written by the LoRA trainer) or are
    re-derived from removal_seed via the group-table samplers.
    """
    masks, behaviors, seeds = [], [], []
    for rec in filter_records(db_path, condition):
        if behavior_key not in rec or rec[behavior_key] is None:
            continue
        mask = np.zeros(num_groups, np.float32)
        if "kept_units" in rec and rec["kept_units"] is not None:
            mask[np.asarray(rec["kept_units"], np.int64)] = 1.0
        else:
            kept, _ = sample_removal(
                rec["removal_dist"], num_groups, seed=int(rec["removal_seed"]),
                alpha=float(rec.get("datamodel_alpha", 0.5)),
            )
            mask[kept] = 1.0
        masks.append(mask)
        behaviors.append(float(rec[behavior_key]))
        seeds.append(int(rec.get("removal_seed", -1)))
    if not masks:
        return np.zeros((0, num_groups), np.float32), np.zeros(0), []
    return np.stack(masks), np.asarray(behaviors), seeds


def base_parser(doc: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=doc)
    parser.add_argument("--dataset", type=str, default="artbench")
    parser.add_argument("--cls", type=str, default="post_impressionism")
    parser.add_argument("--train_db", type=str, required=True)
    parser.add_argument("--test_db", type=str, nargs="+", required=True)
    parser.add_argument("--method", type=str, default="retrain",
                        help="train rows' method (retrain vs sparse_gd)")
    parser.add_argument("--model_behavior_key", type=str,
                        default="aesthetic_score_avg")
    parser.add_argument("--num_groups", type=int, default=258)
    parser.add_argument("--max_train_size", type=int, default=None)
    parser.add_argument("--train_size_step", type=int, default=100)
    parser.add_argument("--v1", type=float, default=None)
    parser.add_argument("--v0", type=float, default=None)
    parser.add_argument("--full_db", type=str, default=None,
                        help="JSONL with the full-model behavior row "
                             "(reference shapley_lds.py:190-209 y_full; "
                             "overrides --v1)")
    parser.add_argument("--null_db", type=str, default=None,
                        help="JSONL with the null/pretrained-only behavior "
                             "row (y_null; overrides --v0)")
    parser.add_argument("--save_dir", type=str, default=None,
                        help="save attrs + global ranking .npy here")
    return parser


def load_test_data(args) -> List[Tuple[np.ndarray, np.ndarray]]:
    test_cond = {"removal_dist": "datamodel", "method": "retrain"}
    out = []
    for db in args.test_db:
        x, y, _ = collect_group_data(
            db, test_cond, args.num_groups, args.model_behavior_key
        )
        if len(x):
            out.append((x, y))
    return out


def run_lds(args, removal_dist: str, fit):
    """Fit at growing sizes, print LDS lines, optionally save attributions;
    returns the last attributions.

    Rows from the antithetic *_paired variant of `removal_dist` are pooled
    into the fit: they are marginally identical draws of the same kernel
    (data/removal.py::remove_data_by_shapley_paired)."""
    parts = []
    for dist in (removal_dist, f"{removal_dist}_paired"):
        cond = {"removal_dist": dist, "method": args.method}
        parts.append(collect_group_data(
            args.train_db, cond, args.num_groups, args.model_behavior_key
        ))
    masks = np.concatenate([p[0] for p in parts], axis=0)
    behaviors = np.concatenate([p[1] for p in parts], axis=0)
    cond = {"removal_dist": removal_dist, "method": args.method}
    if len(masks) == 0:
        raise SystemExit(f"no rows matched {cond} in {args.train_db}")
    test_data = load_test_data(args)
    if not test_data:
        raise SystemExit("no test rows found")

    max_n = args.max_train_size or len(masks)
    sizes = list(range(args.train_size_step, max_n, args.train_size_step)) + [max_n]
    attrs = None
    for n in sizes:
        attrs = fit(masks[:n], behaviors[:n])
        lds_mean, lds_ci = evaluate_lds(attrs, test_data)
        print(f"train_size={n} LDS={lds_mean:.2f} +- {lds_ci:.2f}", flush=True)

    if args.save_dir and attrs is not None:
        os.makedirs(args.save_dir, exist_ok=True)
        tag = f"{removal_dist}_{args.method}_{args.model_behavior_key}"
        np.save(os.path.join(args.save_dir, f"attrs_{tag}.npy"), attrs)
        np.save(
            os.path.join(args.save_dir, f"ranking_{tag}.npy"),
            np.argsort(attrs)[::-1],
        )
        print(f"attrs + ranking saved to {args.save_dir}")
    return attrs


def shapley_fit(args):
    """The closed-form Shapley fit, anchored on the measured full and null
    behaviors of ``--full_db``/``--null_db`` when given (they beat the
    max/min fallback, whose sign is wrong for loss-like behaviors)."""
    def _db_value(path):
        for rec in read_records(path):
            v = rec.get(args.model_behavior_key)
            if v is not None:
                return float(v)
        raise SystemExit(f"no {args.model_behavior_key} row in {path}")

    if args.full_db:
        args.v1 = _db_value(args.full_db)
    if args.null_db:
        args.v0 = _db_value(args.null_db)

    def fit(masks, behaviors):
        v1 = float(args.v1 if args.v1 is not None else behaviors.max())
        v0 = float(args.v0 if args.v0 is not None else behaviors.min())
        return data_shapley(args.num_groups, masks, behaviors, v1, v0).ravel()

    return fit


def convergence_metrics(a: np.ndarray, b: np.ndarray) -> dict:
    """MSE / Pearson / Spearman between two attribution vectors
    (reference shapley_convergence.py:240-268)."""
    return {
        "mse": float(np.mean((a - b) ** 2)),
        "pearson": float(pearsonr(a, b).statistic),
        "spearman": float(spearmanr(a, b).statistic),
    }
