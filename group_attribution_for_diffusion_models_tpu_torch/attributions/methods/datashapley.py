"""Closed-form KernelSHAP attribution.

Port of the JAX package's ``attributions/methods/datashapley.py``, numpy
only and line for line (bit-identical coefficients). The estimator is eq. (7)
of Covert & Lee 2021, "Improving KernelSHAP": a least squares over
(subset-mask, behavior) pairs under the efficiency constraint
sum(coef) = v1 - v0, whose solution is

    coef = A^-1 (b - 1 (1^T A^-1 b - (v1 - v0)) / (1^T A^-1 1))

with A = X^T X / n and b = X^T (y - v0) / n. pinv guards a singular A (few
fit subsets). `kernel_shap` and `kernel_shap_ridge` enforce the constraint
softly with weighted anchor rows; `brute_force_shapley` enumerates every
subset (a test oracle).
"""

from __future__ import annotations

from itertools import combinations
from math import factorial

import numpy as np

from .datamodel import ridge_cv


def data_shapley(
    dataset_size: int,
    x_train: np.ndarray,
    y_train: np.ndarray,
    v1: float,
    v0: float,
) -> np.ndarray:
    """KernelSHAP closed form. x_train: (n, d) 0/1 masks; y_train: (n,).
    Returns (d, 1) coefficients."""
    x = np.asarray(x_train, dtype=np.float64)
    y = np.asarray(y_train, dtype=np.float64).reshape(-1, 1)
    train_size = len(x)

    a_hat = x.T @ x / train_size
    b_hat = x.T @ (y - v0) / train_size

    a_inv = np.linalg.pinv(a_hat)
    one = np.ones((dataset_size, 1))

    c = one.T @ a_inv @ b_hat - v1 + v0
    d = one.T @ a_inv @ one
    coef = a_inv @ (b_hat - one @ (c / d))

    coef[np.abs(coef) < 1e-10] = 0.0
    return coef


def _anchored(dataset_size, x_train, y_train, v1, v0, anchor_weight):
    """(x, y, w) with the all-ones -> v1 and all-zeros -> v0 anchor rows
    appended at weight `anchor_weight`."""
    ones = np.ones((1, dataset_size))
    zeros = np.zeros((1, dataset_size))
    x = np.concatenate([np.asarray(x_train, np.float64), ones, zeros], axis=0)
    y = np.concatenate([np.asarray(y_train, np.float64).ravel(), [v1, v0]])
    w = np.concatenate([np.ones(len(x_train)), [anchor_weight, anchor_weight]])
    return x, y, w


def kernel_shap(
    dataset_size: int,
    x_train: np.ndarray,
    y_train: np.ndarray,
    v1: float,
    v0: float,
    anchor_weight: float = 1e10,
) -> np.ndarray:
    """Weighted-regression KernelSHAP with v1/v0 anchor rows of weight
    `anchor_weight`, which enforce the efficiency constraint softly."""
    x, y, w = _anchored(dataset_size, x_train, y_train, v1, v0, anchor_weight)
    wx = w[:, None] * x
    try:
        coef = np.linalg.solve(x.T @ wx, wx.T @ y)
    except np.linalg.LinAlgError:
        sqrt_w = np.sqrt(w)
        coef = np.linalg.lstsq(sqrt_w[:, None] * x, sqrt_w * y, rcond=None)[0]
    return coef


def kernel_shap_ridge(
    dataset_size: int,
    x_train: np.ndarray,
    y_train: np.ndarray,
    v1: float,
    v0: float,
    anchor_weight: float = 1e4,
    alphas=(1e-20, 2.5e-16, 5e-16, 7.5e-16, 1e-15),
) -> np.ndarray:
    """Ridge-regularised weighted KernelSHAP with anchor rows: `ridge_cv`
    over near-zero alphas on the weight-scaled design."""
    x, y, w = _anchored(dataset_size, x_train, y_train, v1, v0, anchor_weight)
    wx = w[:, None] * x
    return ridge_cv(wx, y, alphas=list(alphas), cv=min(5, len(y)))


def brute_force_shapley(num_players: int, value_fn) -> np.ndarray:
    """Exact Shapley values by full subset enumeration (test oracle only)."""
    values = np.zeros(num_players)
    players = list(range(num_players))
    for i in players:
        others = [p for p in players if p != i]
        for size in range(num_players):
            weight = (
                factorial(size) * factorial(num_players - size - 1)
                / factorial(num_players)
            )
            for subset in combinations(others, size):
                s = set(subset)
                values[i] += weight * (value_fn(s | {i}) - value_fn(s))
    return values
