"""Datamodel attribution: bootstrapped cross-validated ridge regression.

Port of the JAX package's ``attributions/methods/datamodel.py``, numpy only
and line for line, so the two give bit-identical coefficients. Ridge
solutions with an unpenalised intercept (sklearn's RidgeCV semantics, alphas
{0.1, 1, 10}, 5-fold) on bootstrap resamples of (mask, behavior) rows, with
an explicit seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

DEFAULT_ALPHAS = (0.1, 1.0, 10.0)


def _ridge_fit(x: np.ndarray, y: np.ndarray, alpha: float) -> np.ndarray:
    """Ridge with intercept (not penalized), matching sklearn semantics."""
    x_mean = x.mean(axis=0)
    y_mean = y.mean()
    xc, yc = x - x_mean, y - y_mean
    d = x.shape[1]
    return np.linalg.solve(xc.T @ xc + alpha * np.eye(d), xc.T @ yc)


def ridge_cv(
    x: np.ndarray,
    y: np.ndarray,
    alphas: Sequence[float] = DEFAULT_ALPHAS,
    cv: int = 5,
    seed: int = 0,
) -> np.ndarray:
    """K-fold CV over alphas, then refit on all data with the winner."""
    n = len(x)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, cv)

    errs = np.zeros(len(alphas))
    for k in range(cv):
        val_idx = folds[k]
        tr_idx = np.concatenate([folds[j] for j in range(cv) if j != k])
        for a_i, alpha in enumerate(alphas):
            coef = _ridge_fit(x[tr_idx], y[tr_idx], alpha)
            intercept = y[tr_idx].mean() - x[tr_idx].mean(axis=0) @ coef
            pred = x[val_idx] @ coef + intercept
            errs[a_i] += np.mean((pred - y[val_idx]) ** 2)
    best = np.asarray(alphas)[np.argmin(errs)]
    return _ridge_fit(x, y, best)


def datamodel(
    x_train: np.ndarray,
    y_train: np.ndarray,
    num_runs: int = 1,
    seed: int = 0,
) -> np.ndarray:
    """Bootstrapped datamodel coefficients, shape (num_runs, d)."""
    x = np.asarray(x_train, np.float64)
    y = np.asarray(y_train, np.float64).ravel()
    n = len(x)
    rng = np.random.RandomState(seed)
    coeffs = []
    for _ in range(num_runs):
        idx = rng.choice(n, n, replace=True)
        coeffs.append(ridge_cv(x[idx], y[idx], seed=seed))
    return np.stack(coeffs)


def compute_datamodel_scores(
    masks: np.ndarray,
    behaviors: np.ndarray,
    train_idx: Sequence[int],
    val_idx: Sequence[int],
    num_runs: int = 1,
    seed: int = 0,
) -> np.ndarray:
    """Predict val-subset behaviors from train-subset datamodel fits."""
    coeff = datamodel(masks[train_idx], behaviors[train_idx], num_runs, seed)
    return masks[val_idx] @ coeff.T
