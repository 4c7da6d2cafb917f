"""Post-hoc LDS convergence curve of a protocol-scale pipeline DB, on the
PyTorch/CUDA port's estimators (the twin of ``refscale_prefix_curve.py``).

Reads the shapley_pipeline JSONL DB written by
``scripts/refscale_attribution_torch.sh`` (or its JAX twin) and refits
closed-form KernelSHAP on growing prefixes of the paired-Shapley fit rows,
evaluating the Spearman LDS of each prefix fit against the full datamodel test
set in 3 groups. Host-only numpy; run after the pipeline completes.

  python scripts/refscale_prefix_curve_torch.py <db>.jsonl [dataset [steps [method]]] \\
      [--out <curve>.json]

The curve goes to ``--out`` (default: beside the DB, named as the JAX script
names its files). It never writes ``docs/refscale_prefix_curve*.json``, which
hold the JAX package's run.

Where it follows the intended behavior and not the JAX script:
* the test rows are filtered on one step budget, the most common among them
  (the JAX script takes every budget the DB holds, ``refscale_prefix_curve.py:80``);
* the test rows split into 3 groups with ``np.array_split``, so no row is
  dropped (the JAX script's ``len // 3`` slices drop up to 2).
On a DB of one test budget and a test count divisible by 3 the two scripts
give the same curve.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from group_attribution_for_diffusion_models_tpu_torch.attributions.lds import (  # noqa: E402
    evaluate_lds,
)
from group_attribution_for_diffusion_models_tpu_torch.attributions.methods.datashapley import (  # noqa: E402
    data_shapley,
)
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset  # noqa: E402
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import (  # noqa: E402
    filter_records,
)

PREFIXES = (32, 64, 128, 250, 374)
JAX_RUN_FILES = ("refscale_prefix_curve.json", "refscale_prefix_curve_prune_fine_tune.json")


def modal_steps(db, dataset, dist, method):
    """The most common training_steps of the (dist, method) rows, or None."""
    steps = [rec.get("training_steps") for rec in filter_records(
        db, {"dataset": dataset, "removal_dist": dist, "method": method})
        if rec.get("training_steps")]
    return max(set(steps), key=steps.count) if steps else None


def rows_to_xy(db, dataset, dist, lo, hi, n_units, labels, behavior,
               method="retrain", steps=None):
    """(class masks, behaviors) of the scored (dist, method) rows with seeds in
    [lo, hi) at `steps` (any budget when None), sorted by seed. Method and
    step budget are part of a row's identity: after a sparse-FT run the same
    DB holds prune_fine_tune rows for the same (dist, seed) windows."""
    keyed = []
    for rec in filter_records(db, {"dataset": dataset, "removal_dist": dist,
                                   "method": method}):
        if rec.get(behavior) is None:
            continue
        if steps is not None and rec.get("training_steps", steps) != steps:
            continue
        seed = rec.get("removal_seed")
        if seed is None or not (lo <= int(seed) < hi):
            continue
        remaining = np.asarray(rec["remaining_idx"], np.int64)
        m = np.zeros(n_units, np.float32)
        m[np.unique(labels[remaining])] = 1.0
        keyed.append((int(seed), m, float(rec[behavior])))
    keyed.sort(key=lambda t: t[0])
    return (np.stack([m for _, m, _ in keyed]),
            np.asarray([y for _, _, y in keyed]))


def prefix_curve(db, dataset, v1_steps=None, method="retrain", behavior="eval_loss",
                 device="cpu"):
    """The curve's dict: anchors, test count and groups, and the LDS mean and
    CI of each prefix fit (the JAX script's keys and rounding)."""
    labels = np.asarray(create_dataset(dataset, train=True, device=device).labels)
    n_units = int(labels.max()) + 1
    # The v1 anchor comes from the full-distribution row at the fit rows'
    # step budget and method (argv, else the fit rows' most common budget).
    if v1_steps is None:
        v1_steps = modal_steps(db, dataset, "shapley_paired", method)
    x_fit, y_fit = rows_to_xy(db, dataset, "shapley_paired", 100, 100 + 10_000,
                              n_units, labels, behavior, method=method, steps=v1_steps)
    # Test rows are always ground-truth retrains at their own budget.
    x_test, y_test = rows_to_xy(db, dataset, "datamodel", 5000, 5000 + 10_000,
                                n_units, labels, behavior, method="retrain",
                                steps=modal_steps(db, dataset, "datamodel", "retrain"))

    v1 = v0 = None
    for rec in filter_records(db, {"dataset": dataset, "removal_dist": "full",
                                   "method": method}):
        if rec.get(behavior) is None:
            continue
        if rec.get("training_steps") == 0:
            v0 = float(rec[behavior])
        elif v1_steps is None or rec.get("training_steps") == v1_steps:
            v1 = float(rec[behavior])
    if v1 is None or v0 is None:
        print("WARNING: anchors missing (run still in flight?); y-range fallback")
        v1, v0 = float(y_fit.max()), float(y_fit.min())
    print(f"# fit rows {len(x_fit)}, test rows {len(x_test)}, v1={v1}, v0={v0}")

    # 100 test subsets x 3 seed groups, mean +- CI across groups, as the
    # reference evaluates (shapley_lds.py:69,158-166).
    n_grp = 3 if len(x_test) >= 3 else 1
    groups = [(x_test[idx], y_test[idx])
              for idx in np.array_split(np.arange(len(x_test)), n_grp)]

    out = {"dataset": dataset, "behavior": behavior, "method": method,
           "fit_training_steps": v1_steps, "v1": v1, "v0": v0,
           "num_test": int(len(x_test)), "test_groups": n_grp, "curve": []}
    for n in (*PREFIXES, len(x_fit)):
        n = min(n, len(x_fit))
        attrs = data_shapley(n_units, x_fit[:n], y_fit[:n], v1, v0).ravel()
        mean, ci = evaluate_lds(attrs, groups)
        out["curve"].append({"fit": int(n), "lds": round(mean, 2), "ci": round(ci, 2)})
        print(f"fit={n:4d}  LDS = {mean:6.2f} +- {ci:.2f}")
        if n == len(x_fit):
            break
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("db")
    parser.add_argument("dataset", nargs="?", default="synthetic_2048x32_c32_tpl_mix_sizes")
    parser.add_argument("steps", nargs="?", type=int, default=None,
                        help="the fit rows' step budget (default: their most common)")
    parser.add_argument("method", nargs="?", default="retrain",
                        help="the fit rows' method (prune_fine_tune for sparse-FT fits)")
    parser.add_argument("--out", default=None,
                        help="where the curve goes (default: beside the DB)")
    args = parser.parse_args(argv)
    suffix = "" if args.method == "retrain" else f"_{args.method}"
    path = args.out or os.path.join(os.path.dirname(os.path.abspath(args.db)),
                                    f"refscale_prefix_curve{suffix}.json")
    docs = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")
    if os.path.abspath(path) in {os.path.join(docs, f) for f in JAX_RUN_FILES}:
        raise SystemExit(f"{path} holds the JAX package's run; pass another --out")
    out = prefix_curve(args.db, args.dataset, args.steps, args.method)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"-> {path}")
    return out


if __name__ == "__main__":
    main()
