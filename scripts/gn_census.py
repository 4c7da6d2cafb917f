#!/usr/bin/env python3
"""Device time of the GroupNorm(+SiLU) kernels at every GroupNorm shape of a
CIFAR U-Net pass, on one GPU.

Runs `chip_smoke.py`'s census phase (`check_gn_census`: both kernels held
against their plain versions, then the forward kernel, the backward kernel
and the backward as autograd runs it, timed by the profiler's device time,
with totals per U-Net forward and backward beside their bytes bounds, in
float32 and bfloat16) on the port package of the checkout at --tree, so that
the kernels of two trees (a parent commit unpacked with `git archive`, and
this one) are held and timed by the same code, in turns, within one call.
Prints the card, one line a shape and a JSON line of the totals. Run from
the repository root:

    python3 scripts/gn_census.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=ROOT, help="checkout whose port package is timed")
    args = p.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from group_attribution_for_diffusion_models_tpu_torch import ops

    if not os.path.abspath(ops.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {ops.__file__}, not the package under {tree}")
    print(smoke.card_line(), flush=True)
    print(f"tree {tree}; torch {torch.__version__}", flush=True)
    totals = smoke.check_gn_census(torch, ops, torch.device("cuda", 0))
    print(json.dumps({"tree": tree, "batch": smoke.GN_CENSUS_BATCH, "totals": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
