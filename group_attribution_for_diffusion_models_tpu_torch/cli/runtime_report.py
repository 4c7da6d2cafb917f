"""Runtime accounting across a sweep's JSONL databases.

Equivalent of the reference's runtime notebooks
(text_to_image/artbench/runtime_pruning_ratio=0.5.ipynb — the source of the
646 s/subset and 18x speed-up numbers in BASELINE.md): aggregate per-subset
training/sampling/scoring times recorded in result rows, report median and
mean per method, and the speed-up of each method relative to a baseline
method (default: retrain).

Port of the JAX package's ``cli/runtime_report.py``: the same time keys,
grouping and lines, over either package's DBs.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np

from ..utils.jsonl import read_records

TIME_KEYS = ("total_steps_time", "sampling_time", "scoring_time",
             "unlearn_time", "generation_time")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--db", type=str, nargs="+", required=True)
    parser.add_argument("--baseline_method", type=str, default="retrain")
    parser.add_argument("--group_by", type=str, default="method")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    per_group = defaultdict(lambda: defaultdict(list))
    for db in args.db:
        for rec in read_records(db):
            group = rec.get(args.group_by)
            if group is None:
                continue
            total = 0.0
            any_time = False
            for key in TIME_KEYS:
                v = rec.get(key)
                if isinstance(v, (int, float)):
                    per_group[group][key].append(float(v))
                    total += float(v)
                    any_time = True
            if any_time:
                per_group[group]["total"].append(total)

    if not per_group:
        raise SystemExit("no timing fields found in the given DBs")

    baseline_median = None
    if args.baseline_method in per_group:
        baseline_median = float(np.median(per_group[args.baseline_method]["total"]))

    for group in sorted(per_group):
        stats = per_group[group]
        total = np.asarray(stats["total"])
        line = (
            f"{args.group_by}={group}: n={len(total)} "
            f"median_total={np.median(total):.1f}s mean_total={total.mean():.1f}s"
        )
        for key in TIME_KEYS:
            if stats[key]:
                line += f" {key}_median={np.median(stats[key]):.1f}s"
        if baseline_median and group != args.baseline_method:
            line += f" speedup_vs_{args.baseline_method}={baseline_median / max(np.median(total), 1e-9):.2f}x"
        print(line, flush=True)


if __name__ == "__main__":
    main()
