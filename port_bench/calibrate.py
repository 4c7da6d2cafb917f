"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--variants program,tf32,half_batch] [--out chiprun_out/calib.jsonl]

For each seed, in one process: set-up as a run makes it (a sampling cell then
makes one call of its window), the program's record, the reference's, and
the numbers of each variant against the reference:

* ``program``: the program, as a run judges it (sound runs: the lower reading);
* ``tf32``: the control, the reference computed in TF32 in the program's place
  (the precision below the configured float32: the upper reading);
* ``half_batch``: a fault, the reference with half of each batch left out and
  the loss meaned over the rest, in the program's place.

A state left unchanged reads 1 by the training numbers' measure and needs no
run. One JSON line per seed and variant goes to standard output and, with
``--out``, to that file. The benchmark's runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def readings(workload: str, seeds, variants, device: str = "cuda", root: str = ROOT,
             manifest=None, emit=print):
    sys.path.insert(0, BENCH_DIR)
    import torch

    from benchlib import compare, runner
    from benchlib.manifest import Manifest

    manifest = manifest or Manifest(root)
    cell = manifest.cell(workload)
    config, traffic = manifest.config(cell), manifest.traffic(cell)
    port = runner.import_port(root)
    runner.set_numerics(torch, config)
    dev = torch.device(device)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = runner.Context(cell=cell, config=config, traffic=traffic, seed=seed, device=dev,
                             port=port)
        d = manifest.driver(traffic).Driver(ctx)
        d.setup()
        if hasattr(d, "program_images"):  # a sampling cell: one call of its window
            d.window(0.0)
            prog = d.program_images()
        else:
            prog = d.program
        d.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = d.reference()
        for variant in variants:
            got = prog if variant == "program" else d.reference(variant)
            if hasattr(d, "program_images"):
                numbers = {"image_max_abs": float((got - ref).abs().max())}
            else:
                numbers = compare.training_numbers(got, ref)
            row = {"workload": workload, "seed": seed, "variant": variant, "numbers": numbers,
                   "seconds": time.perf_counter() - t0}
            emit(json.dumps(row))
            out.append(row)
        del d
        gc.collect()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--variants", default="program,tf32,half_batch")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None

    def emit(line: str) -> None:
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    try:
        readings(args.workload, seeds, args.variants.split(","), emit=emit)
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
