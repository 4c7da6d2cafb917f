"""Removal-distribution samplers: which training data each subset run keeps.

The port's own copy of the JAX package's ``data/removal.py`` (numpy only, so
it is the same code; the port imports nothing of the JAX package). The
determinism contract is absolute: the same ``seed`` must reproduce the same
subset in the training job, the scoring job and the LDS evaluation, in
either package. Each sampler makes the exact ``np.random.RandomState`` call
sequence of its counterpart in reference src/datasets.py:516-743.

* Samplers take a label array (or dataset size), not a torch Dataset.
* ``remove_data_by_uniform`` has the ``by_class`` parameter the reference's
  callers pass but its signature lacks.
* `removal_masks` builds the (num_subsets, n) 0/1 keep-mask matrix the
  attribution tier consumes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

Labels = Union[Sequence[int], np.ndarray]


def _as_labels(labels: Labels) -> np.ndarray:
    arr = np.asarray(labels)
    if arr.ndim != 1:
        raise ValueError(f"labels must be 1-D, got shape {arr.shape}")
    return arr


def remove_data_by_class(
    labels: Labels, excluded_class: Sequence
) -> Tuple[np.ndarray, np.ndarray]:
    """Remove all data whose (order-normalized) class is in `excluded_class`.

    Mirrors reference src/datasets.py:525-556: raw label values are mapped to
    dense ids by sorted order before matching.
    """
    labels = _as_labels(labels)
    unique_labels = sorted(set(labels.tolist()))
    value_to_number = {label: i for i, label in enumerate(unique_labels)}
    excluded = {value_to_number[c] for c in excluded_class}
    dense = np.array([value_to_number[v] for v in labels.tolist()])
    removed_idx = np.flatnonzero(np.isin(dense, list(excluded)))
    remaining_idx = np.setdiff1d(np.arange(len(labels)), removed_idx)
    return remaining_idx, removed_idx


def remove_data_by_uniform(
    dataset_size_or_labels: Union[int, Labels],
    seed: int = 0,
    by_class: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Independent p=0.5 keep/remove per unit (datum or class).

    Element branch matches reference src/datasets.py:559-579
    (``rng.normal(size=n) > 0``). The by_class branch applies the same draw at
    class granularity — the parameter the reference's callers expect but its
    sampler lacks.
    """
    rng = np.random.RandomState(seed)
    if by_class:
        labels = _as_labels(dataset_size_or_labels)
        classes = np.unique(labels)
        selected_classes = classes[rng.normal(size=len(classes)) > 0]
        keep = np.isin(labels, selected_classes)
        all_idx = np.arange(len(labels))
        return all_idx[keep], all_idx[~keep]
    n = int(dataset_size_or_labels) if np.isscalar(dataset_size_or_labels) else len(
        _as_labels(dataset_size_or_labels)
    )
    selected = rng.normal(size=n) > 0
    all_idx = np.arange(n)
    return all_idx[selected], all_idx[~selected]


def remove_data_by_uniform_paired(
    dataset_size_or_labels: Union[int, Labels],
    seed: int = 0,
    by_class: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Antithetic p=0.5 sampling: seeds 2k/2k+1 draw complementary subsets.

    The complement of a p=0.5 draw is p=0.5-distributed, so marginals match
    remove_data_by_uniform while pairs cancel first-order estimator noise —
    the Banzhaf analog of remove_data_by_shapley_paired (Banzhaf lstsq runs
    on ±1/2-shifted masks, so a pair contributes exactly opposite design
    rows)."""
    remaining, removed = remove_data_by_uniform(
        dataset_size_or_labels, seed // 2, by_class
    )
    if seed % 2:
        return removed, remaining
    return remaining, removed


def remove_data_by_datamodel(
    dataset_size_or_labels: Union[int, Labels],
    alpha: float = 0.5,
    seed: int = 0,
    by_class: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep a uniformly-random alpha-fraction (datamodel subsets).

    Matches reference src/datasets.py:582-628 call-for-call.
    """
    rng = np.random.RandomState(seed)
    if by_class:
        labels = _as_labels(dataset_size_or_labels)
        possible_classes = np.unique(labels).tolist()
        remaining_class_size = int(alpha * len(possible_classes))
        rng.shuffle(possible_classes)
        remaining_classes = possible_classes[:remaining_class_size]
        remaining_idx = np.flatnonzero(np.isin(labels, remaining_classes))
        removed_idx = np.setdiff1d(np.arange(len(labels)), remaining_idx)
    else:
        n = (
            int(dataset_size_or_labels)
            if np.isscalar(dataset_size_or_labels)
            else len(_as_labels(dataset_size_or_labels))
        )
        all_idx = np.arange(n)
        num_selected = int(alpha * n)
        rng.shuffle(all_idx)
        remaining_idx = all_idx[:num_selected]
        removed_idx = all_idx[num_selected:]
    return remaining_idx, removed_idx


def _shapley_size_probs(n: int) -> np.ndarray:
    """Shapley-kernel size PMF p(|S|) ∝ (n-1)/(|S|(n-|S|)) over 1..n-1."""
    sizes = np.arange(1, n)
    probs = (n - 1) / (sizes * (n - sizes))
    return probs / probs.sum()


def remove_data_by_shapley(
    dataset_size_or_labels: Union[int, Labels],
    seed: int = 0,
    by_class: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw the remaining set from the Shapley kernel distribution.

    p(S) = (n-1) / (|S| (n-|S|) C(n,|S|)); sample |S| from the size PMF, then
    a uniform subset of that size. Matches reference src/datasets.py:631-697.
    """
    rng = np.random.RandomState(seed)
    if by_class:
        labels = _as_labels(dataset_size_or_labels)
        possible_classes = np.unique(labels)
        n_cls = len(possible_classes)
        sizes = np.arange(1, n_cls)
        probs = _shapley_size_probs(n_cls)
        remaining_size = rng.choice(sizes, size=1, p=probs)[0]
        all_idx = np.arange(n_cls)
        rng.shuffle(all_idx)
        removed_classes = possible_classes[all_idx[remaining_size:]]
        removed_idx = np.flatnonzero(np.isin(labels, removed_classes))
        remaining_idx = np.setdiff1d(np.arange(len(labels)), removed_idx)
        return remaining_idx, removed_idx
    n = (
        int(dataset_size_or_labels)
        if np.isscalar(dataset_size_or_labels)
        else len(_as_labels(dataset_size_or_labels))
    )
    sizes = np.arange(1, n)
    probs = _shapley_size_probs(n)
    remaining_size = rng.choice(sizes, size=1, p=probs)[0]
    all_idx = np.arange(n)
    rng.shuffle(all_idx)
    return all_idx[:remaining_size], all_idx[remaining_size:]


def remove_data_by_shapley_paired(
    dataset_size_or_labels: Union[int, Labels],
    seed: int = 0,
    by_class: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Antithetic (paired) Shapley-kernel sampling: seeds 2k and 2k+1 draw
    COMPLEMENTARY subsets of one kernel draw.

    The kernel size PMF p(|S|) ∝ (n-1)/(|S|(n-|S|)) is symmetric under
    |S| -> n-|S| and the subset is uniform given its size, so the complement
    of a kernel draw is itself kernel-distributed — each member of a pair is
    marginally identical to an independent draw, while the pair's opposite
    inclusion vectors cancel the dominant noise direction of the constrained
    least squares (Covert & Lee 2021's paired-sampling variance reduction,
    which the reference's sampler never implemented; validated against the
    exact enumerated game in tests/test_groundtruth_cli.py and
    tests/test_removal.py). Sizes are 1..n-1, so complements are never
    empty/full.
    """
    remaining, removed = remove_data_by_shapley(
        dataset_size_or_labels, seed // 2, by_class
    )
    if seed % 2:
        return removed, remaining
    return remaining, removed


def remove_data_by_loo(dataset_size: int, loo_idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Leave-one-out split (reference src/datasets.py:700-707)."""
    removed_idx = np.array([loo_idx])
    remaining_idx = np.setdiff1d(np.arange(dataset_size), removed_idx)
    return remaining_idx, removed_idx


def remove_data_for_aoi(dataset_size: int, aoi_idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Add-one-in split (reference src/datasets.py:710-717)."""
    remaining_idx = np.array([aoi_idx])
    removed_idx = np.setdiff1d(np.arange(dataset_size), remaining_idx)
    return remaining_idx, removed_idx


def removed_by_classes(
    labels: Labels, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Shapley-kernel draw over classes, returning (remaining, removed) class ids.

    Mirrors the (second, live) reference definition src/datasets.py:720-742.
    """
    rng = np.random.RandomState(seed)
    labels = _as_labels(labels)
    possible_classes = np.unique(labels)
    n_cls = len(possible_classes)
    sizes = np.arange(1, n_cls)
    probs = _shapley_size_probs(n_cls)
    remaining_size = rng.choice(sizes, size=1, p=probs)[0]
    all_idx = np.arange(n_cls)
    rng.shuffle(all_idx)
    return (
        possible_classes[all_idx[:remaining_size]],
        possible_classes[all_idx[remaining_size:]],
    )


def sample_removal(
    removal_dist: str,
    dataset_size_or_labels: Union[int, Labels],
    seed: int = 0,
    alpha: float = 0.5,
    by_class: bool = False,
    idx: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatch on the removal-distribution name (the CLI-facing entrypoint)."""
    if removal_dist == "uniform":
        return remove_data_by_uniform(dataset_size_or_labels, seed, by_class)
    if removal_dist == "uniform_paired":
        return remove_data_by_uniform_paired(
            dataset_size_or_labels, seed, by_class
        )
    if removal_dist == "datamodel":
        return remove_data_by_datamodel(dataset_size_or_labels, alpha, seed, by_class)
    if removal_dist == "shapley":
        return remove_data_by_shapley(dataset_size_or_labels, seed, by_class)
    if removal_dist == "shapley_paired":
        return remove_data_by_shapley_paired(
            dataset_size_or_labels, seed, by_class
        )
    if removal_dist == "loo":
        if idx is None:
            raise ValueError("loo requires idx")
        n = (
            int(dataset_size_or_labels)
            if np.isscalar(dataset_size_or_labels)
            else len(_as_labels(dataset_size_or_labels))
        )
        return remove_data_by_loo(n, idx)
    if removal_dist == "aoi":
        if idx is None:
            raise ValueError("aoi requires idx")
        n = (
            int(dataset_size_or_labels)
            if np.isscalar(dataset_size_or_labels)
            else len(_as_labels(dataset_size_or_labels))
        )
        return remove_data_for_aoi(n, idx)
    if removal_dist == "full":
        n = (
            int(dataset_size_or_labels)
            if np.isscalar(dataset_size_or_labels)
            else len(_as_labels(dataset_size_or_labels))
        )
        return np.arange(n), np.array([], dtype=np.int64)
    raise ValueError(f"unknown removal_dist {removal_dist!r}")


def removal_masks(
    removal_dist: str,
    num_units: int,
    seeds: Sequence[int],
    alpha: float = 0.5,
) -> np.ndarray:
    """Batch of binary keep-masks, one row per removal seed.

    This (num_subsets, num_units) matrix is both the ensemble-axis data-mask
    input (parallel.ensemble) and the design matrix of the attribution
    regressions (attributions.methods.*).
    """
    masks = np.zeros((len(seeds), num_units), dtype=np.float32)
    for row, seed in enumerate(seeds):
        remaining, _ = sample_removal(removal_dist, num_units, seed=seed, alpha=alpha)
        masks[row, remaining] = 1.0
    return masks
