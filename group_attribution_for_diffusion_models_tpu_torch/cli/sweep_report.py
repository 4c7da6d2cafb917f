"""Select the best pruning/fine-tuning recipe from a sweep's JSONL rows.

CLI counterpart of the reference's hyperparameter-selection notebook
(text_to_image/artbench/pruning_max_ratio=0.5.ipynb): its cells parse
``ratio=…/lr=…`` out of ``exp_name`` path segments, average the 50
``generated_image_{i}_ssim`` columns per row, grid-search the
(ratio, lr, epochs) combination that best matches retrain, and then trace
SSIM-vs-epochs curves per ratio at the optimal lr.  Here every CLI arg is
already a first-class row key (``utils.jsonl.provenance_row``), so grouping
reads real columns and falls back to the reference's ``key=value`` exp_name
segments only for foreign DBs. Port of the JAX package's
``cli/sweep_report.py``: the same grouping, lines and summary.

Usage:
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.sweep_report \
        --db sweep_db.jsonl --keys pruning_ratio lr training_steps \
        --behavior ssim
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np

from ..utils.jsonl import read_records


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--db", type=str, nargs="+", required=True)
    parser.add_argument("--keys", type=str, nargs="+",
                        default=["pruning_ratio", "lr", "training_steps"],
                        help="grid axes, in row-key (or exp_name k=v) form")
    parser.add_argument("--behavior", type=str, default="ssim",
                        help="row key, or a metric name whose per-image "
                             "generated_image_{i}_<name> columns are averaged")
    parser.add_argument("--curve_x", type=str, default=None,
                        help="trace behavior vs this key per value of the "
                             "first grid key, others fixed at the optimum "
                             "(default: last of --keys)")
    parser.add_argument("--minimize", action="store_true", default=False,
                        help="lower is better (loss-like behaviors)")
    parser.add_argument("--out", type=str, default=None,
                        help="also write the summary as JSON here")
    return parser.parse_args(argv)


def row_value(rec: dict, key: str):
    """Row column, else reference-style ``key=value`` exp_name segment."""
    if rec.get(key) is not None:
        return rec[key]
    for seg in str(rec.get("exp_name") or "").split("/"):
        if seg.startswith(key + "="):
            val = seg.split("=", 1)[1]
            try:
                return float(val) if "." in val or "e" in val else int(val)
            except ValueError:
                return val
    return None


def row_behavior(rec: dict, name: str):
    """Direct key, quantile-suffixed key, or per-image column average."""
    for cand in (name, f"{name}_avg"):
        if isinstance(rec.get(cand), (int, float)):
            return float(rec[cand])
    cols = [v for k, v in rec.items()
            if k.startswith("generated_image_") and k.endswith("_" + name)
            and isinstance(v, (int, float))]
    return float(np.mean(cols)) if cols else None


def main(argv=None):
    args = parse_args(argv)
    groups = defaultdict(list)
    skipped = 0
    for db in args.db:
        for rec in read_records(db):
            y = row_behavior(rec, args.behavior)
            combo = tuple(row_value(rec, k) for k in args.keys)
            if y is None or any(v is None for v in combo):
                skipped += 1
                continue
            groups[combo].append(y)
    if not groups:
        raise SystemExit(
            f"no rows with behavior {args.behavior!r} and keys {args.keys} "
            f"({skipped} rows skipped)"
        )

    sign = -1.0 if args.minimize else 1.0
    table = sorted(
        ((combo, float(np.mean(ys)), len(ys)) for combo, ys in groups.items()),
        key=lambda t: -sign * t[1],
    )
    print(f"{' x '.join(args.keys)} -> mean {args.behavior} (n rows)")
    for combo, mean, n in table:
        print("  " + ", ".join(f"{k}={v}" for k, v in zip(args.keys, combo))
              + f": {mean:.6f} (n={n})")

    best_combo, best_mean, _ = table[0]
    best = dict(zip(args.keys, best_combo))
    print(f"optimal: {best} mean {args.behavior}={best_mean:.6f}")

    # SSIM-vs-epochs curve per ratio at the optimal lr (notebook cells 6-8):
    # sweep curve_x per value of keys[0], all other keys at their optimum.
    curves = {}
    if len(args.keys) >= 2:
        curve_x = args.curve_x or args.keys[-1]
        fixed = [k for k in args.keys[1:] if k != curve_x]
        for combo, mean, _ in table:
            point = dict(zip(args.keys, combo))
            if any(point[k] != best[k] for k in fixed):
                continue
            curves.setdefault(str(point[args.keys[0]]), {})[
                str(point[curve_x])] = mean
        for lead, curve in sorted(curves.items()):
            pts = ", ".join(f"{x}: {y:.6f}" for x, y in sorted(
                curve.items(), key=lambda kv: float(kv[0])))
            print(f"{args.keys[0]}={lead} ({curve_x} -> {args.behavior}): {pts}")

    summary = {
        "behavior": args.behavior,
        "keys": args.keys,
        "optimal": best,
        "optimal_mean": best_mean,
        "n_combos": len(table),
        "n_rows": int(sum(n for _, _, n in table)),
        "skipped_rows": skipped,
        "curves": curves,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
