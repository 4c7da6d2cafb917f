"""FID: feature statistics and Fréchet distance.

The port's copy of the JAX package's ``attributions/global_scores/fid.py``:
numpy and scipy, the same statements, so the numbers are bit-identical.
Feature extraction (the InceptionV3 tower, `inception_v3`) is separate from
the statistics here.

Reference stats are cached as a pickle of ``{"mu", "sigma"}``, the format
the JAX package writes and reads, so either package reads the other's file.
The port adds a ``"tower"`` key naming the feature tower that made the
stats (`inception_v3.inception_tag`); `load_reference_stats` uses a cached
file only when that tag matches, where the JAX CLIs load any file they find.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np
from scipy import linalg


def compute_feature_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an (N, D) feature matrix."""
    features = np.asarray(features, dtype=np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """Fréchet distance between two Gaussians (pytorch_fid semantics).

    ||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with the eps-jitter retry
    for numerically singular products.
    """
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))} in sqrtm"
            )
        covmean = covmean.real

    return float(
        diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def calculate_fid_from_features(
    gen_features: np.ndarray,
    ref_features: Optional[np.ndarray] = None,
    ref_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> float:
    """FID between generated features and reference features or cached stats."""
    mu_g, sigma_g = compute_feature_stats(gen_features)
    if ref_stats is not None:
        mu_r, sigma_r = ref_stats
    elif ref_features is not None:
        mu_r, sigma_r = compute_feature_stats(ref_features)
    else:
        raise ValueError("need ref_features or ref_stats")
    return frechet_distance(mu_g, sigma_g, mu_r, sigma_r)


def save_stats(path: str, mu: np.ndarray, sigma: np.ndarray,
               tower: Optional[str] = None) -> None:
    """Cache reference (mu, sigma), with the tag of the tower that made them
    under "tower" when given."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    entry = {"mu": mu, "sigma": sigma}
    if tower is not None:
        entry["tower"] = tower
    with open(path, "wb") as f:
        pickle.dump(entry, f)


def load_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["mu"], d["sigma"]


def load_reference_stats(
    path: Optional[str], tower: str
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(mu, sigma) cached at `path` if the file exists and was made by
    `tower`; else None, saying on stdout why a file found is not used (no
    tag, as the JAX package writes them, or another tower's)."""
    if not path or not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        d = pickle.load(f)
    found = d.get("tower")
    if found != tower:
        print(f"reference stats {path} were made by tower {found!r}, not {tower!r}: "
              "recomputing them")
        return None
    return d["mu"], d["sigma"]
