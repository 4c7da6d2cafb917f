"""Linear Datamodeling Score (LDS) evaluation.

Port of the JAX package's ``attributions/lds.py`` (numpy and scipy, the
same numbers). LDS is the end-to-end quality metric of the estimation loop:
the Spearman rank correlation (x100) between attribution-predicted subset
behaviors (mask @ attrs) and the behaviors of models retrained on held-out
datamodel subsets, averaged over test groups with a 1.96-SE interval.

`collect_data` selects JSONL rows by a condition dict over the recorded CLI
arguments and rebuilds each row's mask from ``remaining_idx`` (or re-derives
it from ``removal_seed`` where that is absent: the determinism contract of
`data.removal`), optionally collapsed to class granularity.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import spearmanr

from ..data.removal import sample_removal
from ..utils.jsonl import filter_records


def evaluate_lds(
    attrs_all: np.ndarray,
    test_data_list: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_model_behaviors: int = 1,
) -> Tuple[float, float]:
    """Mean LDS x100 and its 1.96-SE interval across test groups."""
    attrs_all = np.asarray(attrs_all)
    if attrs_all.ndim == 1:
        attrs_all = attrs_all[None, :]
    lds_list = []
    for x_test, y_test in test_data_list:
        y_test = np.asarray(y_test)
        if y_test.ndim == 1:
            y_test = y_test[:, None]
        per_behavior = [
            spearmanr(x_test @ attrs_all[k], y_test[:, k]).statistic * 100
            for k in range(num_model_behaviors)
        ]
        lds_list.append(np.mean(per_behavior))
    lds_mean = float(np.mean(lds_list))
    lds_ci = float(np.std(lds_list) / np.sqrt(len(lds_list)) * 1.96)
    return lds_mean, lds_ci


def _row_mask(rec, num_units, by_class, labels) -> np.ndarray:
    """A row's keep-mask over the attribution units."""
    remaining = rec.get("remaining_idx")
    if remaining is None:
        remaining, _ = sample_removal(
            rec["removal_dist"],
            num_units if labels is None else labels,
            seed=int(rec["removal_seed"]),
            alpha=float(rec.get("datamodel_alpha", 0.5)),
            by_class=by_class and labels is not None,
        )
    remaining = np.asarray(remaining, dtype=np.int64)
    mask = np.zeros(num_units, dtype=np.float32)
    if by_class and labels is not None:
        mask[np.unique(np.asarray(labels)[remaining])] = 1.0
    else:
        mask[remaining] = 1.0
    return mask


def collect_data(
    db_path: str,
    condition: Mapping,
    num_units: int,
    behavior_key: str,
    by_class: bool = False,
    labels: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(masks, behaviors, seeds) from a JSONL DB.

    num_units is the mask dimension: dataset size, or number of classes when
    by_class (then `labels` maps datum index -> class).
    """
    masks, behaviors, seeds = [], [], []
    for rec in filter_records(db_path, condition):
        if behavior_key not in rec or rec[behavior_key] is None:
            continue
        masks.append(_row_mask(rec, num_units, by_class, labels))
        behaviors.append(float(rec[behavior_key]))
        seeds.append(int(rec.get("removal_seed", -1)))
    if not masks:
        return (
            np.zeros((0, num_units), np.float32),
            np.zeros((0,), np.float64),
            [],
        )
    return np.stack(masks), np.asarray(behaviors), seeds


def collect_local_data(
    db_path: str,
    condition: Mapping,
    num_units: int,
    behavior_key: str,
    n_samples: int,
    by_class: bool = False,
    labels: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(masks, behaviors (n_rows, n_samples), seeds) for per-image local
    behaviors: the columns are ``generated_image_{i}_{behavior_key}``."""
    masks, behaviors, seeds = [], [], []
    keys = [f"generated_image_{i}_{behavior_key}" for i in range(n_samples)]
    for rec in filter_records(db_path, condition):
        if any(k not in rec or rec[k] is None for k in keys):
            continue
        masks.append(_row_mask(rec, num_units, by_class, labels))
        behaviors.append([float(rec[k]) for k in keys])
        seeds.append(int(rec.get("removal_seed", -1)))
    if not masks:
        return (
            np.zeros((0, num_units), np.float32),
            np.zeros((0, n_samples), np.float64),
            [],
        )
    return np.stack(masks), np.asarray(behaviors), seeds


def bootstrap_lds_ci(
    attrs: np.ndarray,
    x_test: np.ndarray,
    y_test: np.ndarray,
    num_iters: int = 100,
    seed: int = 0,
) -> Tuple[float, float, float]:
    """Bootstrap mean, 2.5% and 97.5% percentiles of LDS over resamples of
    the test rows."""
    rng = np.random.RandomState(seed)
    n = len(x_test)
    vals = []
    for _ in range(num_iters):
        idx = rng.choice(n, n, replace=True)
        vals.append(spearmanr(x_test[idx] @ attrs, y_test[idx]).statistic * 100)
    vals = np.asarray(vals)
    return float(vals.mean()), float(np.percentile(vals, 2.5)), float(
        np.percentile(vals, 97.5)
    )
