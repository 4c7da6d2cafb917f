"""Write the record of one protocol run of the PyTorch/CUDA port, beside the
JAX package's recorded result it repeats.

  python scripts/protocol_record_torch.py --out <name>_h100.json --db <db>.jsonl \\
      --match exp_name=shapley_pipeline --log <run>.log --jax docs/<summary>.json \\
      --rule pipeline --cli "<the command as run>" [--include <curve>.json ...]

The record holds the command as run (and the CLI lines the run's log shows
under ``set -x``), the summary row the run appended to its DB (its args where
the CLI records them), train and total seconds, the largest stacked peak the
log's ``peak ... GiB`` lines name, the card's name and power limit as
nvidia-smi gives them, the commit (``GADM_COMMIT``), any ``--include`` files,
and the JAX package's figures it is compared with, labelled as taken on a TPU.

``--rule`` names the comparison, fixed before the runs:
* ``pipeline``: LDS L +- c agrees with the JAX run's L0 +- c0 when
  |L - L0| <= sqrt(c^2 + c0^2) (each c its package's 1.96 SE over 3 groups);
  v1 and v0 within 5% relative;
* ``groundtruth``: v1 and v0 within 5%, and the paired estimate's Pearson at
  200 fit subsets at least 0.98;
* ``sketch``: each probe variant's group Spearman against ``full`` within 0.01
  of the JAX table's;
* ``curve``: the last prefix's LDS against the JAX curve's, as ``pipeline``.
Host-only: no torch, no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess

ANCHOR_RTOL = 0.05
PEARSON_MIN = 0.98
SPEARMAN_ATOL = 0.01


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def summary_row(db: str, match: dict) -> dict:
    """The last row of `db` whose keys equal `match`'s."""
    found = None
    with open(db) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if all(str(rec.get(k)) == v for k, v in match.items()):
                found = rec
    if found is None:
        raise SystemExit(f"no row of {db} matches {match}")
    return found


def read_log(paths) -> tuple:
    """(largest 'peak X GiB' in GiB or None, the '+ python ...' lines)."""
    peaks, commands = [], []
    for path in paths:
        with open(path, errors="replace") as f:
            for line in f:
                peaks += [float(p) for p in re.findall(r"peak (\d+(?:\.\d+)?) GiB", line)]
                if line.startswith("+ python"):
                    commands.append(line[2:].strip())
    return (max(peaks) if peaks else None), commands


def lds_check(name, got, got_ci, want, want_ci) -> dict:
    limit = math.hypot(got_ci, want_ci)
    return {"figure": name, "port": [got, got_ci], "jax_tpu": [want, want_ci],
            "rule": "|L - L0| <= sqrt(c^2 + c0^2)", "limit": limit,
            "agrees": abs(got - want) <= limit}


def anchor_checks(row: dict, ref: dict) -> list:
    return [{"figure": k, "port": row[k], "jax_tpu": ref[k],
             "rule": f"within {ANCHOR_RTOL:.0%} relative",
             "rel_diff": abs(row[k] - ref[k]) / abs(ref[k]),
             "agrees": abs(row[k] - ref[k]) <= ANCHOR_RTOL * abs(ref[k])}
            for k in ("v1", "v0")]


def compare(rule: str, row: dict, ref: dict, included: dict) -> list:
    if rule == "pipeline":
        return [lds_check("lds", row["lds_mean"], row["lds_ci"], ref["lds_mean"],
                          ref["lds_ci"]), *anchor_checks(row, ref)]
    if rule == "groundtruth":
        got = {(c["dist"], c["fit_subsets"]): c["pearson"] for c in row["convergence"]}
        paired = got[("shapley_paired", 200)]
        want = {(c["dist"], c["fit_subsets"]): c["pearson"] for c in ref["convergence"]}
        return [*anchor_checks(row, ref), {
            "figure": "pearson shapley_paired at 200 fit subsets", "port": paired,
            "jax_tpu": want[("shapley_paired", 200)], "rule": f">= {PEARSON_MIN}",
            "agrees": paired >= PEARSON_MIN}]
    if rule == "sketch":
        table = next(iter(included.values()))
        checks = []
        for name, variant in table["variants"].items():
            if not name.startswith("probe_"):
                continue
            got = variant["spearman_group_vs_full"]
            want = ref["variants"][name]["spearman_group_vs_full"]
            checks.append({"figure": f"{name} spearman_group_vs_full", "port": got,
                           "jax_tpu": want, "rule": f"within {SPEARMAN_ATOL}",
                           "agrees": abs(got - want) <= SPEARMAN_ATOL})
        return checks
    if rule == "curve":
        curve = next(iter(included.values()))
        got, want = curve["curve"][-1], ref["curve"][-1]
        return [lds_check(f"lds at {got['fit']} fit subsets", got["lds"], got["ci"],
                          want["lds"], want["ci"]), *anchor_checks(curve, ref)]
    raise SystemExit(f"unknown --rule {rule}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True)
    parser.add_argument("--cli", required=True, help="the command as run")
    parser.add_argument("--db", default=None, help="the run's DB (its summary row)")
    parser.add_argument("--match", nargs="*", default=[],
                        help="key=value pairs the summary row carries")
    parser.add_argument("--log", nargs="*", default=[], help="the run's output")
    parser.add_argument("--wall_s", type=float, default=None,
                        help="the whole run's wall seconds, where no summary row has them")
    parser.add_argument("--include", nargs="*", default=[], help="JSON files of the run")
    parser.add_argument("--jax", required=True, help="the JAX package's recorded result")
    parser.add_argument("--jax_key", default=None,
                        help="the key of the JAX file that holds the compared figures")
    parser.add_argument("--rule", required=True,
                        choices=["pipeline", "groundtruth", "sketch", "curve"])
    args = parser.parse_args(argv)

    included = {}
    for path in args.include:
        with open(path) as f:
            included[os.path.basename(path)] = json.load(f)
    row = (summary_row(args.db, dict(m.split("=", 1) for m in args.match))
           if args.db else {})
    with open(args.jax) as f:
        jax_file = json.load(f)
    ref = jax_file[args.jax_key] if args.jax_key else jax_file
    peak, commands = read_log(args.log)
    record = {
        "cli": args.cli,
        "commands": commands,
        "args": row.get("args"),
        "summary": row or None,
        "train_time_s": row.get("train_time_s"),
        "total_time_s": row.get("total_time_s"),
        "wall_s": args.wall_s,
        "stacked_peak_gib": peak,
        "card": card(),
        "commit": os.environ.get("GADM_COMMIT"),
        "included": included or None,
        "jax_reference": {"source": args.jax, "key": args.jax_key,
                          "platform": "TPU v5e (the JAX package's run; not this card)"},
        "comparison": compare(args.rule, row, ref, included),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    for check in record["comparison"]:
        print(f"{check['figure']}: port {check['port']} vs JAX {check['jax_tpu']} "
              f"({check['rule']}): {'agrees' if check['agrees'] else 'OUTSIDE'}")
    print(f"-> {args.out}")
    return record


if __name__ == "__main__":
    main()
