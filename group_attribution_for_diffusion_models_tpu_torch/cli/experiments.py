"""Experiment sweep orchestration: command generation + completeness audit.

Mirror of reference text_to_image/experiments/ (10 setup_*_commands.py
scripts, .job templates, run.sh, find_incomplete_trainings.py — SURVEY.md
§2.5, L6). The TPU re-design collapses most of it: where the reference emits
one SLURM array task per removal seed, `gen-commands` emits one
`train_ensemble` invocation per seed *chunk* (a whole array becomes a few
commands), plus per-subset behavior-scoring commands. `find-incomplete`
scans model directories for missing outputs and regenerates the retry
command list (reference find_incomplete_trainings.py). `run` executes a
command file sequentially (the single-host stand-in for run.sh).

Port of the JAX package's ``cli/experiments.py``: the same commands, for the
port's CLIs (which run on CUDA unless a line adds ``--device cpu``). A model
directory is the one the trainers write (`cli.common.removal_dir_name`): for
``--removal_dist full`` that is ``models/full``, where the JAX CLI looks in
``models/full/full``, which no trainer writes (ROADMAP C4).

Subcommands:
    gen-commands     write command.txt for a sweep
    find-incomplete  audit a sweep's outputs, write retry commands
    run              execute a command file line by line
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from .common import removal_dir_name


PKG = "group_attribution_for_diffusion_models_tpu_torch"


def gen_commands(args) -> None:
    cmds = []
    seeds = list(range(args.seed_start, args.seed_start + args.num_seeds))
    chunks = [
        seeds[i : i + args.chunk_size] for i in range(0, len(seeds), args.chunk_size)
    ]
    for chunk in chunks:
        base = (
            f"python -m {PKG}.cli.train_ensemble --dataset {args.dataset} "
            f"--method {args.method} --removal_dist {args.removal_dist} "
            f"--seed_start {chunk[0]} --num_seeds {len(chunk)} "
            f"--outdir {args.outdir} --db {args.db}"
        )
        if args.training_steps:
            base += f" --training_steps {args.training_steps}"
        if args.load:
            base += f" --load {args.load}"
        cmds.append(base)
    if args.with_behaviors:
        for seed in seeds:
            model_dir = os.path.join(args.outdir, args.dataset, args.method, "models",
                                     removal_dir_name(args.removal_dist, seed))
            cmds.append(
                f"python -m {PKG}.cli.calculate_global_scores --dataset "
                f"{args.dataset} --load {model_dir} --outdir {args.outdir} "
                f"--db {args.db} --removal_dist {args.removal_dist} "
                f"--removal_seed {seed}"
            )
    os.makedirs(os.path.dirname(os.path.abspath(args.command_file)), exist_ok=True)
    with open(args.command_file, "w") as f:
        f.writelines(c + "\n" for c in cmds)
    print(f"{len(cmds)} commands -> {args.command_file}")


def find_incomplete(args) -> None:
    missing = []
    for seed in range(args.seed_start, args.seed_start + args.num_seeds):
        model_dir = os.path.join(args.outdir, args.dataset, args.method, "models",
                                 removal_dir_name(args.removal_dist, seed))
        has_ckpt = os.path.isdir(model_dir) and any(
            n.startswith("ckpt_steps_") or n == "lora_weights.npz"
            for n in os.listdir(model_dir)
        )
        if not has_ckpt:
            missing.append(seed)
    if not missing:
        print("sweep complete: no missing trainings")
        return
    print(f"{len(missing)} incomplete: seeds {missing}")
    with open(args.command_file, "w") as f:
        for seed in missing:
            f.write(
                f"python -m {PKG}.cli.train_ensemble --dataset {args.dataset} "
                f"--method {args.method} --removal_dist {args.removal_dist} "
                f"--seed_start {seed} --num_seeds 1 --outdir {args.outdir} "
                f"--db {args.db}\n"
            )
    print(f"retry commands -> {args.command_file}")


def run(args) -> None:
    with open(args.command_file) as f:
        cmds = [line.strip() for line in f if line.strip()]
    for i, cmd in enumerate(cmds):
        print(f"[{i + 1}/{len(cmds)}] {cmd}", flush=True)
        result = subprocess.run(cmd, shell=True)
        if result.returncode != 0 and not args.keep_going:
            sys.exit(result.returncode)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen-commands")
    g.add_argument("--dataset", required=True)
    g.add_argument("--method", default="retrain")
    g.add_argument("--removal_dist", default="shapley")
    g.add_argument("--seed_start", type=int, default=0)
    g.add_argument("--num_seeds", type=int, default=100)
    g.add_argument("--chunk_size", type=int, default=25,
                   help="subset retrains per ensemble invocation")
    g.add_argument("--training_steps", type=int, default=None)
    g.add_argument("--load", default=None)
    g.add_argument("--outdir", required=True)
    g.add_argument("--db", required=True)
    g.add_argument("--command_file", required=True)
    g.add_argument("--with_behaviors", action="store_true", default=False)
    g.set_defaults(fn=gen_commands)

    fi = sub.add_parser("find-incomplete")
    fi.add_argument("--dataset", required=True)
    fi.add_argument("--method", default="retrain")
    fi.add_argument("--removal_dist", default="shapley")
    fi.add_argument("--seed_start", type=int, default=0)
    fi.add_argument("--num_seeds", type=int, default=100)
    fi.add_argument("--outdir", required=True)
    fi.add_argument("--db", required=True)
    fi.add_argument("--command_file", required=True)
    fi.set_defaults(fn=find_incomplete)

    r = sub.add_parser("run")
    r.add_argument("--command_file", required=True)
    r.add_argument("--keep_going", action="store_true", default=False)
    r.set_defaults(fn=run)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
