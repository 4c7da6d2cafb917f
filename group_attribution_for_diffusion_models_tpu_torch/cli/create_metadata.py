"""Build ArtBench metadata + group tables from an image folder.

Port of the JAX package's ``cli/create_metadata.py`` (reference
text_to_image/artbench/create_metadata.py) over the port's `data.groups`:
scan a style's image directory, parse artists from filename prefixes, write
metadata.csv + <style>_artists.csv + <style>_filenames.csv, and assert the
expected class size (the reference's 5000-images-per-style check, :100-110).
Host-only: no device.

Usage:
    python -m group_attribution_for_diffusion_models_tpu_torch.cli.create_metadata \\
        --image_dir <dir of PNGs> --style post_impressionism --expected_count 5000
"""

from __future__ import annotations

import argparse
import os

from ..data.groups import build_group_tables


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--style", type=str, required=True)
    parser.add_argument("--out_dir", type=str, default=None,
                        help="default: the image dir itself")
    parser.add_argument("--expected_count", type=int, default=None,
                        help="e.g. 5000 for full ArtBench styles")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns (artists, filenames), the tables written."""
    args = parse_args(argv)
    files = [f for f in os.listdir(args.image_dir)
             if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))]
    artists, filenames = build_group_tables(
        files, args.style, out_dir=args.out_dir or args.image_dir,
        expected_count=args.expected_count)
    print(f"{len(filenames)} images, {len(artists)} artists -> "
          f"{args.out_dir or args.image_dir}")
    return artists, filenames


if __name__ == "__main__":
    main()
