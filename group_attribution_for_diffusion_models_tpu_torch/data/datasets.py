"""Numpy-native datasets, as far as the ported slices read them.

Port of the JAX package's ``data/datasets.py`` for CIFAR-10, CelebA-HQ,
Imagenette-layout image folders and the deterministic ``synthetic*`` datasets (numpy only, so the same arrays
come out of both packages). Every dataset is an `ArrayDataset`: images
**NHWC float32 in [-1, 1]** plus integer labels. Raw archives are read from
``constants.DATASET_DIR`` in their standard binary formats; CelebA-HQ is a
directory of images with a ``labels.csv`` group table; ``imagenette`` is
``imagenette2/{train,val}/``, every image at 256x256 in name order, group 0,
with its file names (the text-to-image trainer's artists come from them).
The other datasets of the JAX registry (CIFAR-100 variants, MNIST) come with
their slices.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import pickle
import re
from typing import List, Optional, Tuple

import numpy as np

from ..config import constants


@dataclasses.dataclass
class ArrayDataset:
    """Images (N, H, W, C) float32 in [-1, 1] + integer group labels (N,).
    ``names`` optionally carries per-item string ids (the image files of a
    group table)."""

    images: np.ndarray
    labels: np.ndarray
    names: Optional[List[str]] = None

    def __post_init__(self):
        if self.images.ndim != 4 or len(self.images) != len(self.labels):
            raise ValueError(f"images {self.images.shape} and labels {self.labels.shape} "
                             "must be (N, H, W, C) and (N,)")

    def __len__(self) -> int:
        return len(self.images)

    def subset(self, idx: np.ndarray) -> "ArrayDataset":
        names = [self.names[i] for i in idx] if self.names is not None else None
        return ArrayDataset(self.images[idx], self.labels[idx], names)

    @property
    def num_classes(self) -> int:
        return int(len(np.unique(self.labels)))


def _normalize(u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] (the reference's Normalize([0.5],[0.5]))."""
    return (u8.astype(np.float32) / 255.0 - 0.5) / 0.5


def _load_cifar10_raw(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Parse the python-pickle CIFAR-10 archive layout."""
    base = os.path.join(root, "cifar-10-batches-py")
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for fname in files:
        with open(os.path.join(base, fname), "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        xs.append(np.asarray(entry["data"], dtype=np.uint8))
        ys.extend(entry.get("labels", entry.get("fine_labels")))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.asarray(ys, dtype=np.int64)


def category_codes(values: List[str]) -> np.ndarray:
    """pandas' ``read_csv(...)[col].astype("category").cat.codes`` of a CSV
    column read as text: the rank of each value among the sorted distinct
    values, -1 for an empty cell. As pandas infers the column's type, a
    column whose cells all parse as integers (or as numbers) sorts
    numerically, so id 2 comes before id 10; any other column sorts as text."""
    present = [v for v in values if v != ""]
    for parse in (int, float):
        try:
            keys = {v: parse(v) for v in present}
            break
        except ValueError:
            continue
    else:
        keys = {v: v for v in present}
    order = {k: i for i, k in enumerate(sorted(set(keys.values())))}
    return np.asarray([order[keys[v]] if v != "" else -1 for v in values], dtype=np.int64)


def _load_image_dir(root: str, size: int, labels_csv: Optional[str] = None) -> ArrayDataset:
    """A directory of images, optionally with a ``labels.csv`` group table
    whose first two columns are (filename, group); each image decoded to RGB
    and resized to `size` (bilinear) with PIL. Without a table: the image
    files in name order, group 0."""
    from PIL import Image

    if labels_csv is not None:
        with open(labels_csv, newline="") as f:
            rows = list(csv.reader(f))[1:]
        files = [r[0] for r in rows]
        groups = category_codes([r[1] for r in rows])
    else:
        files = sorted(f for f in os.listdir(root)
                       if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
        groups = np.zeros(len(files), dtype=np.int64)
    imgs = np.empty((len(files), size, size, 3), dtype=np.uint8)
    for i, name in enumerate(files):
        with Image.open(os.path.join(root, name)) as im:
            imgs[i] = np.asarray(im.convert("RGB").resize((size, size), Image.BILINEAR),
                                 dtype=np.uint8)
    return ArrayDataset(_normalize(imgs), groups, names=list(files))


def make_synthetic(
    n: int = 256,
    size: int = 32,
    channels: int = 3,
    num_classes: int = 10,
    seed: int = 0,
    heterogeneous: bool = False,
    textured: bool = False,
    templated: bool = False,
    size_ramp: bool = False,
) -> ArrayDataset:
    """Deterministic random dataset for tests and benchmarks, the same draws
    as the JAX package's `make_synthetic`.

    `heterogeneous` ("_mix") scales class k's amplitude by (k+1)/num_classes;
    `textured` ("_tex") box-smooths class k with width 1 + k % 4, renormalised
    to the dataset's std; `templated` ("_tpl") makes an image
    0.85 * template_k + 0.15 * noise; `size_ramp` ("_sizes") draws labels with
    p(class k) proportional to k + 1. The JAX docstring says what each is for.
    """
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1.0, 1.0, size=(n, size, size, channels)).astype(np.float32)
    if size_ramp:
        p = (np.arange(num_classes) + 1).astype(np.float64)
        labels = rng.choice(num_classes, size=n, p=p / p.sum()).astype(np.int64)
    else:
        labels = rng.randint(0, num_classes, size=n).astype(np.int64)
    if templated:
        t_rng = np.random.RandomState(seed + 1)
        templates = t_rng.uniform(
            -1.0, 1.0, size=(num_classes, size, size, channels)
        ).astype(np.float32)
        images = templates[labels] * 0.85 + images * 0.15
    if textured:
        for k in range(num_classes):
            w = 1 + (k % 4)
            if w == 1:
                continue
            idx = np.flatnonzero(labels == k)
            if not len(idx):
                continue
            kernel = np.ones(w, np.float32) / w
            sub = images[idx]
            sub = np.apply_along_axis(
                lambda v: np.convolve(v, kernel, mode="same"), 1, sub
            )
            sub = np.apply_along_axis(
                lambda v: np.convolve(v, kernel, mode="same"), 2, sub
            )
            sub = sub / max(sub.std(), 1e-6) * images.std()
            images[idx] = sub.astype(np.float32)
    if heterogeneous:
        # Last, so the amplitude ramp scales templates too ("_tpl_mix").
        amp = ((labels + 1) / num_classes).astype(np.float32)
        images = images * amp[:, None, None, None]
    return ArrayDataset(images, labels)


def create_dataset(
    dataset_name: str,
    train: bool = True,
    dataset_dir: Optional[str] = None,
) -> ArrayDataset:
    """Build a dataset by name: ``synthetic[_<n>x<s>][_c<k>][_mix|_tex|_tpl|
    _sizes]``, ``cifar``, ``celeba`` (``<root>/celeba_hq/{train,test}/`` with
    its ``labels.csv``) or ``imagenette`` (``<root>/imagenette2/{train,val}/``);
    reference create_dataset src/datasets.py:398-513."""
    root = dataset_dir or constants.DATASET_DIR

    if dataset_name.startswith("synthetic"):
        parts = dataset_name.split("_")
        n, size = 256, 32
        if len(parts) > 1 and "x" in parts[1]:
            n, size = (int(v) for v in parts[1].split("x"))
        num_classes = next(
            (int(p[1:]) for p in parts[2:] if re.fullmatch(r"c\d+", p)), 10
        )
        # "ldm"/"cond"/"big" are workload tokens that cli/common.py's
        # config_for reads; anything else unknown is a typo that would drop a
        # signal.
        known = {"mix", "tex", "tpl", "sizes", "ldm", "cond", "big"}
        bad = [p for p in parts[1:]
               if p not in known and not re.fullmatch(r"\d+x\d+|c\d+", p)]
        if bad:
            raise ValueError(
                f"unknown synthetic dataset token(s) {bad} in {dataset_name!r}"
            )
        return make_synthetic(n=n, size=size, num_classes=num_classes,
                              heterogeneous="mix" in parts,
                              textured="tex" in parts,
                              templated="tpl" in parts,
                              size_ramp="sizes" in parts)

    if dataset_name == "cifar":
        x, y = _load_cifar10_raw(root, train)
        return ArrayDataset(_normalize(x), y)

    if dataset_name == "celeba":
        img_dir = os.path.join(root, "celeba_hq", "train" if train else "test")
        labels_csv = os.path.join(img_dir, "labels.csv")
        return _load_image_dir(img_dir, 256,
                               labels_csv if os.path.exists(labels_csv) else None)

    if dataset_name == "imagenette":
        split = "train" if train else "val"
        return _load_image_dir(os.path.join(root, "imagenette2", split), 256)

    raise ValueError(
        f"dataset_name={dataset_name!r}: the port reads 'cifar', 'celeba', "
        "'imagenette' and 'synthetic*' so far"
    )


def batch_iterator(
    dataset: ArrayDataset,
    batch_size: int,
    seed: int,
    drop_remainder: bool = True,
):
    """Infinite shuffled epoch iterator over numpy (images, labels) batches:
    a `np.random.RandomState(seed)` permutation an epoch, so the order is the
    JAX package's bit for bit."""
    n = len(dataset)
    rng = np.random.RandomState(seed)
    while True:
        perm = rng.permutation(n)
        end = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            idx = perm[i : i + batch_size]
            yield dataset.images[idx], dataset.labels[idx]
