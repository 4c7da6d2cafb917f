"""End-to-end Shapley attribution in one command.

Port of the JAX package's ``cli/shapley_pipeline.py``. It runs the paper's
estimation loop in-process:

  1. train the fit subsets (``--fit_dist``, under ``--method``, from
     ``--load`` for sparse fine-tuning) and the datamodel test subsets (always
     retrained) with chunked ``train_ensemble`` calls, each member scored by
     its fixed-probe eval loss (``--behavior eval_loss``), its training loss
     (``loss``), or the FID or IS of ``--n_samples`` DDIM samples
     (``fid_value``, ``is``: in-loop scoring, the reference stats cached at
     ``<outdir>/inception_ref_stats.pkl`` for every call);
  2. train the null and full anchor models of the fit game (0 and the fit
     budget of steps);
  3. fit the attribution on the fit rows (closed-form KernelSHAP anchored on
     the measured v1/v0, or the matched estimator of ``--fit_dist``) and
     report Spearman LDS against the retrained test rows.

Every row lands in the JSONL DB, then a summary row; the attributions go to
``<outdir>/shapley_pipeline_attrs.npy``. The fit stage (`fit_stage`) is a
function of a DB path, so it also reads a DB the JAX pipeline wrote.

Where the port follows the intended behavior and not the JAX package:
* test subsets train with the test budget passed explicitly, so a run
  without ``--training_steps`` keeps its test rows (the JAX CLI records
  ``training_steps: null`` on them and then filters every one out);
* the 3 LDS test groups come from ``np.array_split``, so no test row is
  dropped (the JAX CLI cuts ``len // 3`` rows a group);
* cached reference stats are used only when they carry the tag of the
  tower in use (``train_ensemble --ref_stats``).

Latent workloads (``--dataset celeba``, ``synthetic_*_ldm``) train on the
VQ-VAE's latents, ``--vqvae_weights`` passed on to every ``train_ensemble``
call (the first call encodes the dataset, the others read its cache). Runs on
CUDA unless ``--device cpu`` is given.

Usage (smoke, CPU):
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.shapley_pipeline \\
        --dataset synthetic_64x8_mix --by_class --num_fit_subsets 6 \\
        --num_test_subsets 4 --training_steps 3 --batch_size 8 \\
        --chunk_size 6 --outdir /tmp/pipe --device cpu
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..attributions import evaluate_lds
from ..attributions.methods import data_shapley
from ..data import create_dataset
from ..utils.device import resolve_device
from ..utils.jsonl import append_record, filter_records
from .common import add_common_args, config_for
from .train_ensemble import MEMBERS_PER_CALL


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--num_fit_subsets", type=int, default=16)
    parser.add_argument("--fit_dist", type=str, default="shapley",
                        choices=["shapley", "shapley_paired", "datamodel",
                                 "uniform", "uniform_paired"],
                        help="fit-subset sampler + estimator family: "
                             "shapley[_paired] -> closed-form KernelSHAP, "
                             "datamodel -> ridge-CV, uniform[_paired] -> Banzhaf; "
                             "*_paired draws antithetic complement pairs")
    parser.add_argument("--num_test_subsets", type=int, default=8)
    parser.add_argument("--test_seed_start", type=int, default=42)
    parser.add_argument("--method", type=str, default="retrain",
                        help="trainer for the fit subsets and the v1/v0 anchors "
                             "(train_ensemble --method); test subsets are always "
                             "retrained")
    parser.add_argument("--load", type=str, default=None,
                        help="shared start checkpoint for the fit subsets and "
                             "anchors (the pruned base for sparse fine-tuning)")
    parser.add_argument("--fit_training_steps", type=int, default=None,
                        help="step budget of the fit subsets where it differs "
                             "from --training_steps (test subsets keep that)")
    parser.add_argument("--training_steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--n_samples", type=int, default=16,
                        help="generated images per member for sample behaviors")
    parser.add_argument("--behavior", type=str, default="eval_loss",
                        choices=["eval_loss", "loss", "fid_value", "is"])
    parser.add_argument("--inception_weights", type=str, default=None,
                        help="InceptionV3 state dict for --behavior fid_value / is "
                             "(default: the seeded random tower)")
    parser.add_argument("--chunk_size", type=int, default=MEMBERS_PER_CALL,
                        help="members per train_ensemble call: the members that "
                             "share one launch of each kernel, all held on the card "
                             f"at once (default {MEMBERS_PER_CALL}: what the CIFAR and "
                             "CelebA workloads fit on one 80 GB H100 at their "
                             "default batch)")
    parser.add_argument("--eval_t_min", type=int, default=0)
    parser.add_argument("--eval_t_max", type=int, default=None,
                        help="probe-timestep band for --behavior eval_loss")
    parser.add_argument("--log_freq", type=int, default=0,
                        help="scan-chunk size in steps (train_ensemble --log_freq: "
                             "the host reads the losses once a chunk; 0 = the whole "
                             "run in one chunk)")
    parser.add_argument(
        "--save_ckpts", action=argparse.BooleanOptionalAction, default=True,
        help="checkpoint every subset member; with --no-save_ckpts the DB row "
             "is the product. The anchor models are always checkpointed.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    return parser.parse_args(argv)


def _ensemble_argv(args, db, method, steps):
    """train_ensemble arguments shared by the subset chunks and the anchors."""
    scored = args.behavior in ("fid_value", "is")
    argv = ["--dataset", args.dataset, "--method", method, "--outdir", args.outdir,
            "--db", db, "--training_steps", str(steps),
            "--n_samples", str(args.n_samples if scored else 0),
            "--num_inference_steps", str(args.num_inference_steps),
            "--log_freq", str(args.log_freq), "--device", args.device]
    if args.behavior == "eval_loss":
        argv += ["--eval_loss", "--eval_t_min", str(args.eval_t_min)]
        if args.eval_t_max:
            argv += ["--eval_t_max", str(args.eval_t_max)]
    if scored:
        # In-loop sampling and Inception scoring of every member; the
        # reference stats cache is shared by the chunks and the anchors.
        argv += ["--score", {"fid_value": "fid", "is": "is"}[args.behavior],
                 "--ref_stats", os.path.join(args.outdir, "inception_ref_stats.pkl")]
        if args.inception_weights:
            argv += ["--inception_weights", args.inception_weights]
    if args.batch_size:
        argv += ["--batch_size", str(args.batch_size)]
    if args.vqvae_weights:
        argv += ["--vqvae_weights", args.vqvae_weights]
    return argv


def _train_chunked(args, dist, seed_start, num, db, steps, method="retrain", load=None):
    """Train seeds [seed_start, seed_start + num) of `dist`, chunk_size members
    a train_ensemble call; returns the calls' summaries."""
    from . import train_ensemble

    summaries = []
    for start in range(seed_start, seed_start + num, args.chunk_size):
        n = min(args.chunk_size, seed_start + num - start)
        argv = _ensemble_argv(args, db, method, steps) + [
            "--removal_dist", dist, "--seed_start", str(start), "--num_seeds", str(n)]
        if load:
            argv += ["--load", load]
        if args.datamodel_alpha and dist.startswith("datamodel"):
            argv += ["--datamodel_alpha", str(args.datamodel_alpha)]
        if args.by_class:
            argv += ["--by_class"]
        if not args.save_ckpts:
            argv += ["--no-save_ckpts"]
        summaries.append(train_ensemble.main(argv))
    return summaries


def _anchor(args, db, steps):
    """The fit game's full-data model after `steps` steps (0: the null model,
    the --load base untouched or a fresh init); returns the call's summary."""
    from . import train_ensemble

    argv = _ensemble_argv(args, db, args.method, steps) + [
        "--removal_dist", "full", "--num_seeds", "1"]
    if args.load:
        argv += ["--load", args.load]
    return train_ensemble.main(argv)


def attribution_units(dataset: str, by_class: bool,
                      device="cuda") -> Tuple[int, Optional[np.ndarray]]:
    """(number of attribution units, labels): classes with --by_class (the
    image-level remaining_idx collapses to a class mask), else images.
    `device` runs a cifar100_new regroup."""
    data = create_dataset(dataset, train=True, device=device)
    if by_class:
        return int(data.labels.max()) + 1, data.labels
    return len(data), None


def rows_to_xy(db: str, dataset: str, dist: str, seed_lo: int, seed_hi: int, method: str,
               steps: int, behavior: str, n_units: int,
               labels: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(masks, behaviors) of the scored rows of (dist, method, step budget)
    with removal seeds in [seed_lo, seed_hi), sorted by seed. Method and step
    budget are part of a row's identity: a DB that holds retrain and
    sparse-FT rows of one (dist, seed) must not mix them in one fit."""
    keyed = []
    for rec in filter_records(db, {"dataset": dataset, "removal_dist": dist,
                                   "method": method}):
        if rec.get(behavior) is None:
            continue
        seed = rec.get("removal_seed")
        if seed is None or not (seed_lo <= int(seed) < seed_hi):
            continue
        if rec.get("training_steps", steps) != steps:
            continue
        remaining = np.asarray(rec["remaining_idx"], np.int64)
        m = np.zeros(n_units, np.float32)
        if labels is not None:
            m[np.unique(labels[remaining])] = 1.0
        else:
            m[remaining] = 1.0
        keyed.append((int(seed), m, float(rec[behavior])))
    keyed.sort(key=lambda t: t[0])
    if not keyed:
        return np.zeros((0, n_units)), np.zeros(0)
    return np.stack([m for _, m, _ in keyed]), np.asarray([y for _, _, y in keyed])


def anchor_values(db: str, dataset: str, method: str, behavior: str,
                  v1_steps: int) -> Tuple[Optional[float], Optional[float]]:
    """(v1, v0): the behaviors of the fit game's full model (v1_steps steps)
    and null model (0 steps), the last such rows of the DB; None where
    missing."""
    v1 = v0 = None
    for rec in filter_records(db, {"dataset": dataset, "removal_dist": "full",
                                   "method": method}):
        if rec.get(behavior) is None:
            continue
        if rec.get("training_steps") == 0:
            v0 = float(rec[behavior])
        elif rec.get("training_steps") == v1_steps:
            v1 = float(rec[behavior])
    return v1, v0


def fit_attrs(fit_dist: str, n_units: int, x_fit: np.ndarray, y_fit: np.ndarray,
              v1: float, v0: float) -> np.ndarray:
    """Closed-form KernelSHAP on the measured anchors for shapley[_paired];
    the matched estimator (cli.lds.fit_attribution) for the others."""
    if fit_dist in ("shapley", "shapley_paired"):
        return data_shapley(n_units, x_fit, y_fit, v1, v0).ravel()
    from .lds import fit_attribution

    return fit_attribution(fit_dist, x_fit, y_fit, n_units, v1=v1, v0=v0).ravel()


def lds_groups(x_test: np.ndarray, y_test: np.ndarray):
    """The seed-sorted test rows in 3 groups when each holds 10 or more rows
    (Spearman over a handful of points is degenerate), else 1. Intended
    behavior: `np.array_split` keeps every row, where the JAX CLI's
    ``len // 3`` slices drop up to 2."""
    n_grp = 3 if len(x_test) >= 30 else 1
    return [(x_test[idx], y_test[idx])
            for idx in np.array_split(np.arange(len(x_test)), n_grp)]


def fit_stage(db: str, dataset: str, behavior: str, fit_dist: str, method: str,
              fit_seeds: Tuple[int, int], test_seeds: Tuple[int, int], fit_steps: int,
              test_steps: int, n_units: int, labels: Optional[np.ndarray] = None) -> Dict:
    """Rows -> (x, y), the anchors, the fit and LDS, from the DB at `db`.
    Returns attrs, the fit and test (x, y), v1, v0, lds_mean, lds_ci,
    lds_pooled and test_groups."""
    x_fit, y_fit = rows_to_xy(db, dataset, fit_dist, *fit_seeds, method, fit_steps,
                              behavior, n_units, labels)
    x_test, y_test = rows_to_xy(db, dataset, "datamodel", *test_seeds, "retrain",
                                test_steps, behavior, n_units, labels)
    if len(x_fit) < 2 or len(x_test) < 2:
        raise SystemExit(
            f"not enough scored rows (fit {len(x_fit)}, test {len(x_test)})"
        )
    # Efficiency-constraint anchors: v1/v0 are the behaviors of the full-data
    # and null models of the fit game. y.max()/y.min() would flip the
    # constraint's sign for any behavior that falls with more data.
    v1, v0 = anchor_values(db, dataset, method, behavior, fit_steps)
    if v1 is None or v0 is None:
        print("WARNING: missing full/null anchor rows; "
              "falling back to y-range anchors")
        v1, v0 = float(y_fit.max()), float(y_fit.min())
    attrs = fit_attrs(fit_dist, n_units, x_fit, y_fit, v1, v0)
    groups = lds_groups(x_test, y_test)
    lds_mean, lds_ci = evaluate_lds(attrs, groups)
    lds_pooled, _ = evaluate_lds(attrs, [(x_test, y_test)])
    return dict(attrs=attrs, x_fit=x_fit, y_fit=y_fit, x_test=x_test, y_test=y_test,
                v1=v1, v0=v0, lds_mean=lds_mean, lds_ci=lds_ci, lds_pooled=lds_pooled,
                test_groups=len(groups))


def main(argv=None):
    """Run the CLI. Returns the fit stage's dict (attrs, the fit and test
    (x, y), v1, v0, LDS) with the summary row (`row`), the DB path, the
    training seconds (every train_ensemble call, set-up, sampling and scoring
    included) and `seconds`: that clock's training, sampling, tower, FID math
    and latent-encode (or cache-read) seconds summed over the calls."""
    args = parse_args(argv)
    resolve_device(args.device)
    db = args.db or os.path.join(args.outdir, f"{args.dataset}_pipeline_db.jsonl")
    t0 = time.time()

    if args.fit_dist.endswith("_paired") and (
        args.removal_seed % 2 or args.num_fit_subsets % 2
    ):
        # Pairs are (2k, 2k+1): an odd start offsets every pair and an odd
        # count leaves one draw unpaired; the marginals stay right but the
        # antithetic variance reduction degrades.
        print(
            f"WARNING: {args.fit_dist} wants an even --removal_seed and "
            f"--num_fit_subsets to form complete antithetic pairs "
            f"(got seed={args.removal_seed}, n={args.num_fit_subsets})"
        )
    fit_lo = args.removal_seed
    fit_hi = fit_lo + args.num_fit_subsets
    test_lo = args.test_seed_start
    test_hi = test_lo + args.num_test_subsets
    if args.fit_dist == "datamodel" and fit_lo < test_hi and test_lo < fit_hi:
        raise SystemExit(
            f"--fit_dist datamodel: fit seeds [{fit_lo},{fit_hi}) overlap "
            f"test seeds [{test_lo},{test_hi}): the same (dist, seed) rows "
            f"would appear on both sides; pick a disjoint --removal_seed"
        )
    budgets = config_for(args.dataset).train.training_steps
    test_steps = (args.training_steps if args.training_steps is not None
                  else budgets.get("retrain", 1000))
    fit_steps = (args.fit_training_steps if args.fit_training_steps is not None
                 else args.training_steps if args.training_steps is not None
                 else budgets.get(args.method, 1000))
    # Fit subsets train under --method (prune_fine_tune from --load); test
    # subsets are always ground-truth retrains, the asymmetry the method
    # comparison rests on. The test budget is passed explicitly (intended
    # behavior; the JAX CLI leaves it out, see the module docstring).
    calls = _train_chunked(args, args.fit_dist, fit_lo, args.num_fit_subsets, db, fit_steps,
                           method=args.method, load=args.load)
    calls += _train_chunked(args, "datamodel", test_lo, args.num_test_subsets, db, test_steps)
    # The anchors belong to the fit game: under prune_fine_tune the null model
    # is the loaded pruned base untouched, v1 the base fine-tuned on all data
    # for the fit budget. The null model goes first: the trained full model
    # then claims the 'full' leaf's final checkpoint.
    calls += [_anchor(args, db, 0), _anchor(args, db, fit_steps)]
    train_time = time.time() - t0
    seconds = {key: sum(c[f"{key}_seconds"] for c in calls)
               for key in ("train", "sample", "tower", "fid", "encode")}

    n_units, labels = attribution_units(args.dataset, args.by_class, args.device)
    out = fit_stage(db, args.dataset, args.behavior, args.fit_dist, args.method,
                    (fit_lo, fit_hi), (test_lo, test_hi), fit_steps, test_steps,
                    n_units, labels)
    total_time = time.time() - t0
    n_fit, n_test = len(out["x_fit"]), len(out["x_test"])
    summary = {
        "exp_name": args.exp_name or "shapley_pipeline",
        "dataset": args.dataset,
        "method": args.method,
        "num_fit_subsets": int(n_fit),
        "num_test_subsets": int(n_test),
        "behavior": args.behavior,
        "fit_training_steps": int(fit_steps),
        "v1": out["v1"],
        "v0": out["v0"],
        "lds_mean": out["lds_mean"],
        "lds_ci": out["lds_ci"],
        "test_groups": out["test_groups"],
        "lds_pooled": out["lds_pooled"],
        "train_time_s": round(train_time, 1),
        "total_time_s": round(total_time, 1),
        "subset_passes_per_hour": round((n_fit + n_test) / (train_time / 3600.0), 1),
    }
    append_record(db, summary)
    np.save(os.path.join(args.outdir, "shapley_pipeline_attrs.npy"), out["attrs"])
    print(
        f"LDS = {out['lds_mean']:.2f} +- {out['lds_ci']:.2f} over {n_test} test subsets "
        f"({n_fit} fit subsets, {summary['subset_passes_per_hour']}/h) "
        f"in {total_time:.1f}s -> {db}"
    )
    return dict(out, row=summary, db=db, train_seconds=train_time, seconds=seconds)


if __name__ == "__main__":
    main()
