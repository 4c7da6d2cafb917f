"""K-means for the cifar100_new regroup, in numpy.

The JAX package runs ``sklearn.cluster.KMeans(n_clusters, random_state,
n_init=10)``; the port keeps its own copy of that algorithm, so it needs no
scikit-learn: greedy k-means++ seeding (``2 + ln k`` candidate centers a
step, the one that lowers the potential most kept), then Lloyd iterations
until the centers move less than ``tol`` times the mean feature variance
(squared, summed; sklearn's default tolerance) or ``max_iter`` passes, an
empty cluster moved to the point farthest from its center, and the run of
least inertia among ``n_init`` restarts. Distances are computed in float64.
The random draws are the port's own (``np.random.RandomState(seed)``), so
labels match sklearn's as a partition, not id for id.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _sq_dists(x: np.ndarray, x_sq: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """(N, K) squared Euclidean distances, clipped at 0."""
    d = x_sq[:, None] - 2.0 * (x @ centers.T) + np.einsum("kd,kd->k", centers, centers)[None]
    return np.maximum(d, 0.0)


def kmeans_plusplus(x: np.ndarray, k: int, rng: np.random.RandomState,
                    x_sq: np.ndarray) -> np.ndarray:
    """Greedy k-means++ seeding of `k` centers among the rows of `x`."""
    n = len(x)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    centers[0] = x[rng.randint(n)]
    closest = _sq_dists(x, x_sq, centers[:1])[:, 0]
    potential = closest.sum()
    for c in range(1, k):
        draws = rng.uniform(size=trials) * potential
        candidates = np.searchsorted(np.cumsum(closest), draws)
        candidates = np.minimum(candidates, n - 1)
        dists = np.minimum(closest[None], _sq_dists(x, x_sq, x[candidates]).T)
        best = int(np.argmin(dists.sum(axis=1)))
        closest = dists[best]
        potential = closest.sum()
        centers[c] = x[candidates[best]]
    return centers


def _lloyd(x: np.ndarray, x_sq: np.ndarray, centers: np.ndarray, max_iter: int,
           tol: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Lloyd iterations from `centers`: (labels, centers, inertia), the labels
    those of the final centers."""
    k = len(centers)
    for _ in range(max_iter):
        dists = _sq_dists(x, x_sq, centers)
        labels = np.argmin(dists, axis=1)
        onehot = np.zeros((k, len(x)), dtype=x.dtype)
        onehot[labels, np.arange(len(x))] = 1.0
        counts = np.bincount(labels, minlength=k)
        new = (x.T @ onehot.T).T  # this operand order takes BLAS's fast path
        empty = np.flatnonzero(counts == 0)
        if len(empty):
            # Relocate empty clusters to the points farthest from their centers.
            far = np.argsort(dists[np.arange(len(x)), labels])[::-1][:len(empty)]
            new[empty] = x[far]
            counts[empty] = 1
        new /= counts[:, None]
        shift = float(((new - centers) ** 2).sum())
        centers = new
        if shift <= tol:
            break
    dists = _sq_dists(x, x_sq, centers)
    labels = np.argmin(dists, axis=1)
    return labels, centers, float(dists[np.arange(len(x)), labels].sum())


def kmeans(features: np.ndarray, k: int, n_init: int = 10, seed: int = 0,
           max_iter: int = 300, tol: float = 1e-4) -> Tuple[np.ndarray, np.ndarray, float]:
    """(labels (N,) int64, centers (k, D), inertia) of the best of `n_init`
    k-means++-seeded Lloyd runs on the rows of `features`."""
    x = np.asarray(features, dtype=np.float64)
    if len(x) < k:
        raise ValueError(f"{len(x)} points for {k} clusters")
    x = x - x.mean(axis=0)  # as sklearn: distances are shift-invariant, rounding is not
    x_sq = np.einsum("nd,nd->n", x, x)
    abs_tol = tol * float(np.mean(np.var(x, axis=0)))
    rng = np.random.RandomState(seed)
    best = None
    for _ in range(n_init):
        centers = kmeans_plusplus(x, k, rng, x_sq)
        labels, centers, inertia = _lloyd(x, x_sq, centers, max_iter, abs_tol)
        if best is None or inertia < best[2]:
            best = (labels, centers, inertia)
    labels, centers, inertia = best
    return labels.astype(np.int64), centers + np.asarray(features, np.float64).mean(axis=0), inertia
