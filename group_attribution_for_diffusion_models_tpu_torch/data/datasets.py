"""Numpy-native datasets.

Port of the JAX package's ``data/datasets.py`` (numpy only, so the same
arrays come out of both packages). Every dataset is an `ArrayDataset`:
images **NHWC float32 in [-1, 1]** plus integer labels. Raw archives are
read from ``constants.DATASET_DIR`` in their standard binary formats:

* ``cifar``: CIFAR-10 (``cifar-10-batches-py``);
* ``cifar2``: CIFAR-10 kept to automobile and horse, relabelled 0/1;
* ``cifar100``: the 20 fine classes of CIFAR-100's 4 animal superclasses
  (``cifar-100-python``), relabelled 0..19 in sorted class order;
* ``cifar100_f``: CIFAR-100 with 2 (k + 1) images of class k, drawn from
  ``RandomState(42)``;
* ``cifar100_new``: the ``cifar100`` images in 40 groups, k-means of their
  ResNet-18 embeddings (`cifar100_regroup`), cached in
  ``<root>/cifar100_new_targets.npy`` as the JAX package caches them;
* ``mnist``: the idx files of ``MNIST/raw``, padded 28 -> 32 with -1;
* ``celeba``: CelebA-HQ, a directory of images with a ``labels.csv`` group
  table;
* ``imagenette``: ``imagenette2/{train,val}/``, every image at 256x256 in
  name order, group 0, with its file names (the text-to-image trainer's
  artists come from them);
* ``synthetic*``: deterministic random datasets for tests.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import pickle
import re
import struct
from typing import List, Optional, Tuple

import numpy as np

from ..config import constants
from .kmeans import kmeans

# CIFAR-10 class indices: 1 = automobile, 7 = horse (reference src/datasets.py:22-56).
CIFAR2_CLASSES = (1, 7)

# The CIFAR-100 fine labels of the 4 animal superclasses the paper's CIFAR-100
# experiments keep (reference CIFAR100_original, src/datasets.py:59-118).
CIFAR100_ANIMAL_SUPERCLASSES = {
    "aquatic_mammals": [4, 30, 55, 72, 95],
    "fish": [1, 32, 67, 73, 91],
    "large_carnivores": [3, 42, 43, 88, 97],
    "large_omnivores_and_herbivores": [15, 19, 21, 31, 38],
}
CIFAR100_NEW_GROUPS = 40  # k-means pseudo-groups of cifar100_new


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


def _load_cifar100_raw(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The ``cifar-100-python`` pickle's images (N, 32, 32, 3) uint8 and fine labels."""
    with open(os.path.join(root, "cifar-100-python", "train" if train else "test"), "rb") as f:
        entry = pickle.load(f, encoding="latin1")
    x = np.asarray(entry["data"], dtype=np.uint8).reshape(-1, 3, 32, 32)
    return x.transpose(0, 2, 3, 1), np.asarray(entry["fine_labels"], dtype=np.int64)


def _load_mnist_raw(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The idx files of ``MNIST/raw``: images (N, 28, 28, 1) uint8 and labels."""
    prefix = "train" if train else "t10k"
    base = os.path.join(root, "MNIST", "raw")
    with open(os.path.join(base, f"{prefix}-images-idx3-ubyte"), "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols, 1)
    with open(os.path.join(base, f"{prefix}-labels-idx1-ubyte"), "rb") as f:
        _, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)
    return images, labels


def _cifar100_animals(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The images of the 20 animal fine classes, relabelled 0..19 in sorted
    class order (reference CIFAR100_original, src/datasets.py:59-118)."""
    kept = np.asarray(sorted(c for sc in CIFAR100_ANIMAL_SUPERCLASSES.values() for c in sc))
    mask = np.isin(y, kept)
    return x[mask], np.searchsorted(kept, y[mask]).astype(np.int64)


def _cifar100_imbalanced(x: np.ndarray, y: np.ndarray,
                         seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Class k keeps 2 (k + 1) of its images, drawn from ``RandomState(seed)``
    one class after another, in index order (reference CIFAR100_filter,
    src/datasets.py:273-310)."""
    rng = np.random.RandomState(seed)
    keep = []
    for cls in range(100):
        idx = np.flatnonzero(y == cls)
        rng.shuffle(idx)
        keep.extend(idx[: 2 * (cls + 1)].tolist())
    keep = np.asarray(sorted(keep), dtype=np.int64)
    return x[keep], y[keep]


def cifar100_regroup(features: np.ndarray, num_groups: int = CIFAR100_NEW_GROUPS,
                     seed: int = 0) -> np.ndarray:
    """Per-image group labels: k-means of per-image features (N, D) into
    `num_groups` groups (reference CIFAR100_regroup.apply_clustering,
    src/datasets.py:198-235, which runs ``KMeans(n_clusters=40,
    random_state=0)`` on ResNet-18 embeddings; `data.kmeans.kmeans` with 10
    restarts, as the JAX package's sklearn call). The draws and the group ids
    are the port's own: on well-separated features the partition is
    sklearn's, elsewhere one of about the same inertia."""
    labels, _, _ = kmeans(np.asarray(features), num_groups, n_init=10, seed=seed)
    return labels


def _cifar100_new_groups(root: str, images01: np.ndarray, device) -> np.ndarray:
    """The cached cifar100_new group labels, or the regroup of `images01`
    (NHWC in [0, 1]) by the ResNet-18 of ``GADM_RESNET18_WEIGHTS`` on
    `device`, written to the cache."""
    cache = os.path.join(root, "cifar100_new_targets.npy")
    if os.path.exists(cache):
        groups = np.load(cache)
        if len(groups) != len(images01):
            raise ValueError(f"{cache} holds {len(groups)} targets for {len(images01)} images")
        return groups.astype(np.int64)
    weights = os.environ.get("GADM_RESNET18_WEIGHTS")
    if not weights:
        raise ValueError(
            "cifar100_new needs per-image ResNet-18 group labels: "
            f"no cache at {cache} and GADM_RESNET18_WEIGHTS is unset "
            "(a torchvision resnet18 state dict, or its .npz from the JAX package's "
            "cli.convert_weights --kind resnet18)")
    from ..models.resnet import load_resnet18, resnet18_embed

    feats = resnet18_embed(load_resnet18(weights, device=device), images01)
    groups = cifar100_regroup(feats)
    np.save(cache, groups)
    return groups


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
    and resized to `size` (bilinear). Without a table: the image files in
    name order, group 0. The native loader (`utils.native_images`) decodes
    the whole directory where it is built; PIL decodes it otherwise, and
    when the directory holds a format the native decoder rejects (webp, CMYK
    JPEG: ValueError), as the JAX loader does."""
    from PIL import Image

    from ..utils.native_images import load_image_batch

    if labels_csv is not None:
        with open(labels_csv, newline="") as f:
            rows = list(csv.reader(f))[1:]
        files = [r[0] for r in rows]
        groups = category_codes([r[1] for r in rows])
    else:
        files = sorted(f for f in os.listdir(root)
                       if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
        groups = np.zeros(len(files), dtype=np.int64)
    paths = [os.path.join(root, name) for name in files]
    try:
        imgs = load_image_batch(paths, size)
    except ValueError:
        imgs = None
    if imgs is None:
        imgs = np.empty((len(files), size, size, 3), dtype=np.uint8)
        for i, path in enumerate(paths):
            with Image.open(path) as im:
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
    device="cuda",
) -> ArrayDataset:
    """Build a dataset by name: ``synthetic[_<n>x<s>][_c<k>][_mix|_tex|_tpl|
    _sizes]``, ``cifar``, ``cifar2``, ``cifar100``, ``cifar100_f``,
    ``cifar100_new``, ``mnist``, ``celeba`` (``<root>/celeba_hq/{train,test}/``
    with its ``labels.csv``) or ``imagenette``
    (``<root>/imagenette2/{train,val}/``); reference create_dataset
    src/datasets.py:398-513. `device` runs the ResNet-18 of a cifar100_new
    regroup, when no cached labels exist."""
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
    if dataset_name == "cifar2":
        x, y = _load_cifar10_raw(root, train)
        mask = np.isin(y, CIFAR2_CLASSES)
        return ArrayDataset(_normalize(x[mask]), (y[mask] == CIFAR2_CLASSES[1]).astype(np.int64))
    if dataset_name in ("cifar100", "cifar100_f", "cifar100_new"):
        x, y = _load_cifar100_raw(root, train)
        if dataset_name == "cifar100_f":
            x, y = _cifar100_imbalanced(x, y)
            return ArrayDataset(_normalize(x), y)
        x, y = _cifar100_animals(x, y)
        images = _normalize(x)
        if dataset_name == "cifar100_new":
            y = _cifar100_new_groups(root, (images + 1.0) / 2.0, device)
        return ArrayDataset(images, y)
    if dataset_name == "mnist":
        x, y = _load_mnist_raw(root, train)
        pad = ((0, 0), (2, 2), (2, 2), (0, 0))  # 28 -> 32 in black, for sample_size 32
        return ArrayDataset(np.pad(_normalize(x), pad, constant_values=-1.0), y)

    if dataset_name == "celeba":
        img_dir = os.path.join(root, "celeba_hq", "train" if train else "test")
        labels_csv = os.path.join(img_dir, "labels.csv")
        return _load_image_dir(img_dir, 256,
                               labels_csv if os.path.exists(labels_csv) else None)

    if dataset_name == "imagenette":
        split = "train" if train else "val"
        return _load_image_dir(os.path.join(root, "imagenette2", split), 256)

    raise ValueError(
        f"dataset_name={dataset_name!r} should be one of ['cifar', 'cifar2', 'cifar100', "
        "'cifar100_f', 'cifar100_new', 'mnist', 'celeba', 'imagenette', 'synthetic*']"
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
