"""LDS of retraining-free baseline attributions saved as .npy vectors.

Port of the JAX package's ``cli/baseline_lds.py`` (reference baseline_lds.py
(root :315-511) and text_to_image/baseline_lds.py:150-202): load per-group
attribution vectors (pixel/CLIP similarity, aesthetic, the TRAK family:
whatever `cli.traks` or `cli.similarity_baselines` saved), flip the sign for
loss-like behaviors (reference text_to_image/baseline_lds.py:150-153), and
report LDS against datamodel-retrain test DBs, with optional bootstrap CIs
(`attributions.bootstrap_lds_ci`). `main` returns {path: (LDS, CI)}.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..attributions import bootstrap_lds_ci, evaluate_lds
from ._tti_lds import load_test_data

LOSS_LIKE = ("simple_loss", "nrmse", "mse", "diffusion_loss", "loss")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--attrs", type=str, nargs="+", required=True,
                        help=".npy attribution vectors to evaluate")
    parser.add_argument("--test_db", type=str, nargs="+", required=True)
    parser.add_argument("--model_behavior_key", type=str,
                        default="aesthetic_score_avg")
    parser.add_argument("--num_groups", type=int, default=258)
    parser.add_argument("--bootstrapped", action="store_true", default=False)
    parser.add_argument("--num_bootstrap_iters", type=int, default=100)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    test_data = load_test_data(args)
    if not test_data:
        raise SystemExit("no test rows found")
    sign = -1.0 if any(k in args.model_behavior_key for k in LOSS_LIKE) else 1.0

    out = {}
    for path in args.attrs:
        attrs = np.load(path).ravel() * sign
        if attrs.shape[0] != args.num_groups:
            print(f"{path}: shape {attrs.shape} != num_groups {args.num_groups}; skipped")
            continue
        lds_mean, lds_ci = out[path] = evaluate_lds(attrs, test_data)
        line = f"{path}: LDS={lds_mean:.2f} +- {lds_ci:.2f}"
        if args.bootstrapped:
            x_all = np.concatenate([x for x, _ in test_data])
            y_all = np.concatenate([y for _, y in test_data])
            _, lo, hi = bootstrap_lds_ci(attrs, x_all, y_all, args.num_bootstrap_iters)
            line += f" bootstrap=[{lo:.2f}, {hi:.2f}]"
        print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
