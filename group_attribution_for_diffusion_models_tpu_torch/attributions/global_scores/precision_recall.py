"""Improved precision and recall via k-NN feature manifolds, on the device.

The port of the JAX package's ``attributions/global_scores/precision_recall.py``
(Kynkäänniemi et al. 2019). Pairwise distances keep the JAX module's
formula, ||a||^2 + ||b||^2 - 2 a.b clamped at 0 in float32, one product
(not ``torch.cdist``), so the kth-NN radii and the coverage agree with it.

Precision is the fraction of generated samples inside the real manifold
(within some real point's kth-NN radius); recall is the converse. Manifolds
cache as a pickle of ``{"features", "radii"}``, the JAX module's format.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...utils.device import resolve_device


class Manifold(NamedTuple):
    features: np.ndarray  # (N, D)
    radii: np.ndarray  # (N,) kth-NN distances


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (n, m) through one product."""
    a2 = torch.sum(a * a, dim=1, keepdim=True)
    b2 = torch.sum(b * b, dim=1, keepdim=True)
    d = a2 + b2.T - 2.0 * (a @ b.T)
    return torch.clamp_min(d, 0.0)


def _kth_nn_radii(features: torch.Tensor, k: int) -> torch.Tensor:
    """kth nearest-neighbour distance of each row, itself excluded."""
    d = _pairwise_sq_dists(features, features)
    d.fill_diagonal_(float("inf"))
    smallest = torch.topk(d, k, dim=1, largest=False).values
    return torch.sqrt(smallest[:, -1])


def build_manifold(features: np.ndarray, nhood_size: int = 3, device="cuda") -> Manifold:
    feats = np.asarray(features, np.float32)
    radii = _kth_nn_radii(torch.from_numpy(feats).to(resolve_device(str(device))), nhood_size)
    return Manifold(feats, radii.cpu().numpy())


def _covered(queries: np.ndarray, manifold: Manifold, device: torch.device) -> float:
    """Fraction of queries that some ball of the manifold (its point, its
    radius) contains."""
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(device)
    refs = torch.from_numpy(np.asarray(manifold.features, np.float32)).to(device)
    radii = torch.from_numpy(np.asarray(manifold.radii, np.float32)).to(device)
    d = torch.sqrt(_pairwise_sq_dists(q, refs))
    return float(torch.any(d <= radii[None, :], dim=1).double().mean())


def compute_precision_recall(
    real_features: np.ndarray,
    gen_features: np.ndarray,
    nhood_size: int = 3,
    real_manifold: Optional[Manifold] = None,
    device="cuda",
) -> Tuple[float, float]:
    """(precision, recall) between real and generated feature sets."""
    device = resolve_device(str(device))
    if real_manifold is None:
        real_manifold = build_manifold(real_features, nhood_size, device)
    gen_manifold = build_manifold(gen_features, nhood_size, device)
    precision = _covered(gen_features, real_manifold, device)
    recall = _covered(real_manifold.features, gen_manifold, device)
    return precision, recall


def save_manifold(path: str, manifold: Manifold) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"features": manifold.features, "radii": manifold.radii}, f)


def load_manifold(path: str) -> Manifold:
    with open(path, "rb") as f:
        d = pickle.load(f)
    return Manifold(d["features"], d["radii"])
