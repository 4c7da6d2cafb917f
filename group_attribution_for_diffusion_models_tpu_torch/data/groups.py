"""Group tables for text-to-image contributor attribution (ArtBench).

The port's own copy of the JAX package's ``data/groups.py`` (numpy only, so
both packages draw the same splits from the same seeds). Mirrors reference
text_to_image/artbench/create_metadata.py: build ``metadata.csv``
(file_name, caption columns) and ``<style>_artists.csv`` /
``<style>_filenames.csv`` group tables from an ArtBench-style image folder
where the artist is the filename prefix up to the last two '_'-separated
tokens (reference create_metadata.py:54). Group-unit removal samples over
the GROUP table and selects images whose unit is kept (reference
train_text_to_image_lora.py:935-1024).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .removal import sample_removal


def artist_from_filename(file_name: str) -> str:
    """`vincent-van-gogh_starry-night_1889.jpg` -> `vincent-van-gogh`."""
    base = os.path.basename(file_name)
    stem = base.rsplit(".", 1)[0]
    return stem.rsplit("_", 2)[0] if stem.count("_") >= 2 else stem.split("_")[0]


def build_group_tables(
    image_files: Sequence[str],
    style: str,
    out_dir: Optional[str] = None,
    captions: Optional[Dict[str, str]] = None,
    expected_count: Optional[int] = None,
) -> Tuple[List[str], List[str]]:
    """(artists, filenames) tables; optionally persisted as CSVs.

    `expected_count` asserts the class size like the reference's 5000-row
    check (create_metadata.py:107-110).
    """
    files = sorted(os.path.basename(f) for f in image_files)
    if expected_count is not None and len(files) != expected_count:
        raise ValueError(
            f"{style}: expected {expected_count} images, found {len(files)}"
        )
    artists = sorted({artist_from_filename(f) for f in files})
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{style}_artists.csv"), "w") as f:
            f.write("artist\n")
            f.writelines(a + "\n" for a in artists)
        with open(os.path.join(out_dir, f"{style}_filenames.csv"), "w") as f:
            f.write("filename\n")
            f.writelines(n + "\n" for n in files)
        with open(os.path.join(out_dir, "metadata.csv"), "w") as f:
            f.write("file_name,caption\n")
            for name in files:
                cap = (captions or {}).get(name, f"a painting in the style of {style}")
                f.write(f"{name},\"{cap}\"\n")
    return artists, files


def load_group_table(csv_path: str) -> List[str]:
    with open(csv_path) as f:
        rows = [line.strip() for line in f if line.strip()]
    return rows[1:] if rows and not rows[0].startswith(("http", "/")) else rows


def group_removal_split(
    image_files: Sequence[str],
    group_units: Sequence[str],
    removal_dist: str,
    removal_seed: int = 0,
    alpha: float = 0.5,
    unit: str = "artist",
    idx: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(remaining_image_idx, removed_image_idx, kept_unit_mask).

    Removal operates on the GROUP table with the seed-deterministic samplers,
    then selects images whose unit is kept (reference
    train_text_to_image_lora.py:935-1024).
    """
    unit_of = (
        [artist_from_filename(f) for f in image_files]
        if unit == "artist"
        else [os.path.basename(f) for f in image_files]
    )
    unit_index = {u: i for i, u in enumerate(group_units)}
    missing = set(unit_of) - set(group_units)
    if missing:
        raise ValueError(f"images reference unknown units: {sorted(missing)[:5]}")

    kept_units_idx, _ = sample_removal(
        removal_dist, len(group_units), seed=removal_seed, alpha=alpha, idx=idx
    )
    kept = np.zeros(len(group_units), dtype=bool)
    kept[kept_units_idx] = True

    img_unit_idx = np.asarray([unit_index[u] for u in unit_of])
    keep_mask = kept[img_unit_idx]
    remaining = np.flatnonzero(keep_mask)
    removed = np.flatnonzero(~keep_mask)
    return remaining, removed, kept.astype(np.float32)


def counterfactual_split(
    image_files: Sequence[str],
    group_units: Sequence[str],
    ranking: np.ndarray,
    proportion: float,
    direction: str = "top",
    unit: str = "artist",
) -> Tuple[np.ndarray, np.ndarray]:
    """Remove the top/bottom `proportion` of units by an attribution ranking
    (reference train_text_to_image_lora.py:596-604,991-1014)."""
    n_remove = int(round(len(group_units) * proportion))
    order = np.asarray(ranking)
    removed_units = set(
        (order[:n_remove] if direction == "top" else order[::-1][:n_remove]).tolist()
    )
    unit_of = (
        [artist_from_filename(f) for f in image_files]
        if unit == "artist"
        else [os.path.basename(f) for f in image_files]
    )
    unit_index = {u: i for i, u in enumerate(group_units)}
    img_unit = np.asarray([unit_index[u] for u in unit_of])
    removed = np.flatnonzero(np.isin(img_unit, list(removed_units)))
    remaining = np.setdiff1d(np.arange(len(image_files)), removed)
    return remaining, removed
