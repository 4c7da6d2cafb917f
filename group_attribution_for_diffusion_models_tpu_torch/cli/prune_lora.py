"""Prune LoRA rank pairs by magnitude importance.

Port of the JAX package's ``cli/prune_lora.py`` (reference
text_to_image/prune_lora.py:62-217): score every (down-col, up-row) rank-1
pair, greedily remove the globally lowest until only (1 - pruning_ratio) of
the LoRA parameters remain, and save the pruned weights (the JAX
``lora_weights.npz`` layout) and info.csv (parameter counts and the ratio
reached). Heterogeneous per-projection ranks are leaf shapes. Numpy on the
host, bit for bit the JAX CLI's output.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

from ..models.lora import load_lora_npz, lora_num_params, lora_ranks, prune_lora, save_lora_npz


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--lora_dir", type=str, required=True,
                        help="trained LoRA .npz")
    parser.add_argument("--pruning_ratio", type=float, default=0.5)
    parser.add_argument("--min_rank", type=int, default=1)
    parser.add_argument("--save_path", type=str, required=True)
    return parser.parse_args(argv)


def main(argv=None) -> Dict:
    """Returns the parameter counts, the ratio reached and the ranks."""
    args = parse_args(argv)
    tree = load_lora_npz(args.lora_dir)
    n_before = lora_num_params(tree)
    pruned = prune_lora(tree, args.pruning_ratio, args.min_rank)
    n_after = lora_num_params(pruned)
    save_lora_npz(args.save_path, pruned)

    info_path = os.path.join(os.path.dirname(os.path.abspath(args.save_path)), "info.csv")
    with open(info_path, "w") as f:
        f.write("params_before,params_after,actual_ratio,requested_ratio\n")
        f.write(f"{n_before},{n_after},{1 - n_after / n_before:.4f},{args.pruning_ratio}\n")
    ranks = lora_ranks(pruned)
    print(f"pruned LoRA: {n_before:,} -> {n_after:,} params "
          f"(removed {1 - n_after / n_before:.1%}); ranks "
          f"min={min(ranks.values())} max={max(ranks.values())} -> {args.save_path}")
    return {"params_before": n_before, "params_after": n_after,
            "actual_ratio": 1 - n_after / n_before, "ranks": ranks, "info": info_path}


if __name__ == "__main__":
    main()
