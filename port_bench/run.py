"""The benchmark of the PyTorch/CUDA port on one NVIDIA H100.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (see ``port_bench/README.md``) from the
root of a checkout and prints its result as the last line of standard
output. It needs the card: without CUDA, or with fewer cards than the cell
asks for, it prints no result and exits with 2.
"""

import time

_T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Kernel caches inside the checkout, at fixed paths.
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, ".bench_cache", "nv"))
    sys.path.insert(0, BENCH_DIR)
    from benchlib import runner

    try:
        result = runner.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            started=min(runner.process_start(), _T0))
    except runner.RunError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    runner.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
