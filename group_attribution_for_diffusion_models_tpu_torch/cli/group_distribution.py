"""Per-group score distribution report (which groups score highest?).

Port of the JAX package's ``cli/group_distribution.py``, the CLI
counterpart of the reference's dataset-distribution notebook
(text_to_image/notebooks/artbench_distribution.ipynb): one score per image
(``--scores``, an .npy), grouped by a filenames CSV (the artist prefix of
each file name, ``data.groups.artist_from_filename``) or by a dataset's
labels, and the groups' statistics (count, median, mean, quartiles, min,
max) ordered by median, highest first: printed (the top and bottom
``--top``) and, with ``--out``, written as JSON. Numpy on the host;
``--device`` runs only the ResNet-18 of a cifar100_new regroup.

Usage:
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.group_distribution \\
        --scores image_aesthetic_score.npy \\
        --filenames_csv post_impressionism_filenames.csv
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.groups import artist_from_filename, load_group_table


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--scores", type=str, required=True,
                        help=".npy of one score per image")
    parser.add_argument("--filenames_csv", type=str, default=None,
                        help="per-image filename table; group = artist prefix")
    parser.add_argument("--dataset", type=str, default=None,
                        help="group by this dataset's labels instead")
    parser.add_argument("--top", type=int, default=10,
                        help="print the top/bottom N groups by median")
    parser.add_argument("--out", type=str, default=None,
                        help="also write the full table as JSON here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the ResNet-18 that regroups cifar100_new "
                             "when its group labels are not cached")
    return parser.parse_args(argv)


def group_stats(scores: np.ndarray, group_of: list) -> list:
    """Per-group stats dicts ordered by median, descending (groups of equal
    median in order of first appearance)."""
    indices = {}
    for i, g in enumerate(group_of):
        indices.setdefault(str(g), []).append(i)
    rows = []
    for g, idx in indices.items():
        v = scores[np.asarray(idx)]
        rows.append({
            "group": g,
            "count": len(idx),
            "median": float(np.median(v)),
            "mean": float(np.mean(v)),
            "q25": float(np.quantile(v, 0.25)),
            "q75": float(np.quantile(v, 0.75)),
            "min": float(v.min()),
            "max": float(v.max()),
        })
    rows.sort(key=lambda r: -r["median"])
    return rows


def main(argv=None):
    """Run the CLI; returns the ordered table."""
    args = parse_args(argv)
    scores = np.load(args.scores).ravel()
    if args.filenames_csv:
        group_of = [artist_from_filename(f) for f in load_group_table(args.filenames_csv)]
    elif args.dataset:
        from ..data import create_dataset

        group_of = create_dataset(args.dataset, train=True, device=args.device).labels.tolist()
    else:
        raise SystemExit("need --filenames_csv or --dataset for the grouping")
    if len(group_of) != len(scores):
        raise SystemExit(f"{len(scores)} scores but {len(group_of)} grouped images")

    rows = group_stats(scores, group_of)
    print(f"{len(rows)} groups over {len(scores)} images "
          f"(overall median {np.median(scores):.4f})")
    shown = rows if len(rows) <= 2 * args.top else (
        rows[:args.top] + [None] + rows[-args.top:])
    for r in shown:
        if r is None:
            print(f"  ... {len(rows) - 2 * args.top} more ...")
            continue
        print(f"  {r['group']}: median={r['median']:.4f} mean={r['mean']:.4f} "
              f"[q25={r['q25']:.4f}, q75={r['q75']:.4f}] n={r['count']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
