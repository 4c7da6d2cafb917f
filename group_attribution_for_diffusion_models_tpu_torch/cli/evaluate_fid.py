"""FID and IS between two image directories.

Port of the JAX package's ``cli/evaluate_fid.py``: FID of ``--generated_dir``
against ``--reference_dir`` or cached reference stats (``--ref_stats``, used
when they carry the tag of the tower in use, else recomputed from
``--reference_dir`` and saved), and the generated images' Inception Score,
which the JAX CLI does not report. Appends a JSONL row with ``--db``. Runs on
CUDA unless ``--device cpu`` is given; on CUDA, TF32 is off.
"""

from __future__ import annotations

import argparse

import torch

from ..attributions.global_scores import (
    calculate_fid_from_features,
    compute_feature_stats,
    inception_score_from_logits,
    inception_tag,
    load_inception,
    load_reference_stats,
    make_feature_fn,
    save_stats,
)
from ..utils.device import resolve_device
from ..utils.jsonl import append_record
from .common import load_sample_dir


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--generated_dir", type=str, required=True)
    parser.add_argument("--reference_dir", type=str, default=None)
    parser.add_argument("--ref_stats", type=str, default=None)
    parser.add_argument("--inception_weights", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--db", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for the Inception tower")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns {"fid_value", "is", "is_std"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    extract = make_feature_fn(load_inception(args.inception_weights, device=device),
                              batch_size=args.batch_size)

    gen_feats, gen_logits = extract(load_sample_dir(args.generated_dir))
    tag = inception_tag(args.inception_weights)
    stats = load_reference_stats(args.ref_stats, tag)
    if stats is None:
        if not args.reference_dir:
            raise SystemExit("need --reference_dir or --ref_stats made by this tower")
        stats = compute_feature_stats(extract(load_sample_dir(args.reference_dir))[0])
        if args.ref_stats:
            save_stats(args.ref_stats, *stats, tower=tag)

    fid_value = calculate_fid_from_features(gen_feats, ref_stats=stats)
    is_mean, is_std = inception_score_from_logits(gen_logits)
    print(f"fid_value={fid_value:.4f} is={is_mean:.4f}+-{is_std:.4f}")
    result = {"fid_value": fid_value, "is": is_mean, "is_std": is_std}
    if args.db:
        append_record(args.db, {"generated_dir": args.generated_dir,
                                "reference_dir": args.reference_dir, **result})
    return result


if __name__ == "__main__":
    main()
