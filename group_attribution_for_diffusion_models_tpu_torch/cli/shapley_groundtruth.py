"""Ground-truth Shapley convergence: exact values from exhaustive retrains.

Port of the JAX package's ``cli/shapley_groundtruth.py``. Every one of the
2^C - 1 non-empty class subsets retrains as an ensemble member
(``cli.train_ensemble --removal_dist enum --removal_masks``, eval-loss
behavior; v(empty set) is the untrained null model, the pipeline's v0),
exact Shapley values follow by full enumeration (`brute_force_shapley` over
the measured value table), and KernelSHAP estimates at increasing fit-subset
counts are scored against them by lookup into the same game, so the sweep
trains nothing more. Rows are filtered on the retrain budget and the eval
band, so a re-run into an outdir of other settings fails loudly instead of
mixing stale rows. One summary row, the exact vector as
``shapley_groundtruth_exact.npy``.

Runs on CUDA unless ``--device cpu`` is given.

Usage (smoke, CPU):
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.shapley_groundtruth \\
        --dataset synthetic_64x8_c4_tpl_mix --training_steps 4 --outdir /tmp/gt \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
from scipy import stats

from ..attributions.methods import brute_force_shapley, data_shapley
from ..data import create_dataset, sample_removal
from ..utils.jsonl import append_record, filter_records
from . import train_ensemble
from .common import add_common_args, config_for


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--training_steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--chunk_size", type=int, default=32,
                        help="members per ensemble invocation")
    parser.add_argument("--eval_t_min", type=int, default=0)
    parser.add_argument("--eval_t_max", type=int, default=None)
    parser.add_argument("--log_freq", type=int, default=0,
                        help="tracker log interval in steps (0 = only final)")
    parser.add_argument("--fit_counts", type=str, default="10,24,50,100,200",
                        help="KernelSHAP fit-subset counts for the convergence curve "
                             "(even counts keep shapley_paired's pairs complete)")
    parser.add_argument("--num_estimate_seeds", type=int, default=3,
                        help="independent estimate draws averaged per count")
    parser.add_argument("--estimate_dists", type=str, default="shapley,shapley_paired",
                        help="fit-subset samplers to compare against the exact game")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def _ensemble_argv(args, db, extra):
    argv = ["--dataset", args.dataset, "--outdir", args.outdir, "--db", db,
            "--n_samples", "0", "--eval_loss", "--eval_t_min", str(args.eval_t_min),
            "--no-save_ckpts", "--device", args.device, *extra]
    if args.eval_t_max:
        argv += ["--eval_t_max", str(args.eval_t_max)]
    if args.vqvae_weights:
        argv += ["--vqvae_weights", args.vqvae_weights]
    return argv


def _train_enum(args, masks_path, num_masks, db):
    """Every enumerated subset, `--chunk_size` members a train_ensemble call
    (only the rows feed the game: no member checkpoints)."""
    for start in range(0, num_masks, args.chunk_size):
        n = min(args.chunk_size, num_masks - start)
        extra = ["--removal_dist", "enum", "--removal_masks", masks_path, "--by_class",
                 "--seed_start", str(start), "--num_seeds", str(n),
                 "--log_freq", str(args.log_freq),
                 "--training_steps", str(args.training_steps)]
        if args.batch_size:
            extra += ["--batch_size", str(args.batch_size)]
        train_ensemble.main(_ensemble_argv(args, db, extra))


def main(argv=None):
    """Run the CLI. Returns {"exact", "v1", "v0", "summary"}: the exact
    Shapley values, the full and null models' values and the summary row."""
    args = parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    db = args.db or os.path.join(args.outdir, f"{args.dataset}_groundtruth_db.jsonl")
    t0 = time.time()
    # Rows are filtered on the effective budget, so resolve it first.
    if args.training_steps is None:
        args.training_steps = config_for(args.dataset).train.training_steps.get("retrain", 1000)

    labels = create_dataset(args.dataset, train=True, device=args.device).labels
    n_classes = int(labels.max()) + 1
    if n_classes > 12:
        raise SystemExit(
            f"{n_classes} classes -> {2**n_classes - 1} subsets; cap the class count (e.g. a "
            "synthetic_*_c8_* dataset) to keep exhaustive enumeration feasible")

    # Non-empty class subsets; mask row s encodes the integer s + 1.
    num_masks = 2**n_classes - 1
    masks = np.array([[(m >> k) & 1 for k in range(n_classes)]
                      for m in range(1, num_masks + 1)], dtype=np.int8)
    masks_path = os.path.join(args.outdir, "enum_masks.npy")
    np.save(masks_path, masks)

    # 1) retrain every subset; 2) the untrained null anchor (v of the empty set).
    _train_enum(args, masks_path, num_masks, db)
    train_ensemble.main(_ensemble_argv(args, db, [
        "--removal_dist", "full", "--num_seeds", "1", "--training_steps", "0"]))
    train_time = time.time() - t0

    # 3) the measured value table v[mask int]; v[0] is the untrained null model.
    v = np.full(num_masks + 1, np.nan)
    for rec in filter_records(db, {"dataset": args.dataset, "removal_dist": "enum"}):
        if rec.get("eval_loss") is None:
            continue
        if (rec.get("training_steps") != args.training_steps
                or rec.get("eval_t_min") != args.eval_t_min
                or rec.get("eval_t_max") != args.eval_t_max):
            continue  # a stale row from a differently configured run
        kept = np.unique(labels[np.asarray(rec["remaining_idx"], np.int64)])
        v[int(np.sum(1 << kept))] = float(rec["eval_loss"])
    for rec in filter_records(db, {"dataset": args.dataset, "removal_dist": "full"}):
        if rec.get("training_steps") == 0 and rec.get("eval_loss") is not None:
            v[0] = float(rec["eval_loss"])
    missing = int(np.isnan(v).sum())
    if missing:
        raise SystemExit(
            f"{missing} subset values missing from {db} at "
            f"training_steps={args.training_steps} "
            f"eval_t=[{args.eval_t_min},{args.eval_t_max}); a reused outdir with different "
            "settings skips retrains on existing rows; use a fresh --outdir")
    v0, v1 = float(v[0]), float(v[num_masks])

    # 4) exact Shapley over the measured game.
    exact = brute_force_shapley(
        n_classes,
        lambda s: v[int(np.sum(1 << np.array(sorted(s), np.int64)))] if s else v0)
    exact_spread = float(np.std(exact))
    rel_spread = exact_spread / max(abs(float(np.mean(exact))), 1e-12)
    if rel_spread < 0.05:
        print(f"WARNING: exact Shapley values are near-uniform (std {exact_spread:.2e}, "
              f"{100 * rel_spread:.1f}% of |mean|): Pearson/Spearman against them are "
              "noise-dominated on this game; judge convergence by mse", flush=True)

    # 5) KernelSHAP estimates at increasing fit counts, valued by lookup.
    def _estimate(count, seed0, dist):
        xs, ys = [], []
        for j in range(count):
            remaining, _ = sample_removal(dist, labels, seed=seed0 + j, by_class=True)
            kept = np.unique(labels[remaining])
            m = np.zeros(n_classes, np.float32)
            m[kept] = 1.0
            xs.append(m)
            ys.append(v[int(np.sum(1 << kept))])
        return data_shapley(n_classes, np.stack(xs), np.asarray(ys), v1, v0).ravel()

    curve = []
    fit_counts = [int(c) for c in args.fit_counts.split(",")]
    dists = [d.strip() for d in args.estimate_dists.split(",") if d.strip()]
    for dist in dists:
        for count in fit_counts:
            pearsons, spearmans, mses = [], [], []
            for e in range(args.num_estimate_seeds):
                # an even seed0 keeps shapley_paired's (2k, 2k+1) pairs aligned
                est = _estimate(count, seed0=10_000 * (e + 1), dist=dist)
                pearsons.append(float(stats.pearsonr(est, exact)[0]))
                spearmans.append(float(stats.spearmanr(est, exact)[0]))
                mses.append(float(np.mean((est - exact) ** 2)))
            curve.append({"dist": dist, "fit_subsets": count,
                          "pearson": round(float(np.mean(pearsons)), 4),
                          "spearman": round(float(np.mean(spearmans)), 4),
                          "mse": float(np.mean(mses))})

    total_time = time.time() - t0
    summary = {
        "exp_name": args.exp_name or "shapley_groundtruth",
        "dataset": args.dataset,
        "removal_dist": "groundtruth_summary",
        "args": dict(vars(args)),
        "n_classes": n_classes,
        "num_enumerated": num_masks,
        "v1": v1,
        "v0": v0,
        "exact_std": exact_spread,
        "exact_rel_spread": rel_spread,
        "convergence": curve,
        "train_time_s": round(train_time, 1),
        "total_time_s": round(total_time, 1),
        "subset_passes_per_hour": round((num_masks + 1) / (train_time / 3600.0), 1),
    }
    append_record(db, summary)
    np.save(os.path.join(args.outdir, "shapley_groundtruth_exact.npy"), exact)
    print(f"ground-truth convergence (exact Shapley from {num_masks} exhaustive retrains):")
    for row in curve:
        print(f"  {row['dist']:>16s} fit={row['fit_subsets']:>4d}  "
              f"Pearson={row['pearson']:+.3f}  Spearman={row['spearman']:+.3f}  "
              f"mse={row['mse']:.3e}")
    print(json.dumps(summary))
    return {"exact": exact, "v1": v1, "v0": v0, "summary": summary}


if __name__ == "__main__":
    main()
