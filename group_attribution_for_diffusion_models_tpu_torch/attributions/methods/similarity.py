"""Retraining-free similarity baselines: pixel distance, embedding similarity,
class/group aggregation.

Port of the JAX package's ``attributions/methods/similarity.py`` (reference
src/attributions/methods/attribution_utils.py: aggregate_by_class :15-48,
CLIPScore :80-163, pixel_distance :166-217; the text_to_image
pixel_similarity.py, clip_similarity.py and aesthetic_score.py scripts).
The similarity is one normalised f32 product on the device (numpy in and
out); the aggregation is numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ...utils.device import resolve_device


def cosine_similarity_matrix(a: np.ndarray, b: np.ndarray, device="cuda") -> np.ndarray:
    """(n, m) cosine similarities between the rows of `a` and of `b`, float32
    on `device`."""
    device = resolve_device(str(device))
    a_t = torch.from_numpy(np.asarray(a, np.float32)).to(device)
    b_t = torch.from_numpy(np.asarray(b, np.float32)).to(device)
    a_t = a_t / torch.clamp(a_t.norm(dim=1, keepdim=True), min=1e-12)
    b_t = b_t / torch.clamp(b_t.norm(dim=1, keepdim=True), min=1e-12)
    return (a_t @ b_t.T).cpu().numpy()


def pixel_distance_scores(gen_images: np.ndarray, train_images: np.ndarray,
                          device="cuda") -> np.ndarray:
    """Raw-pixel cosine similarity (n_gen, n_train)
    (reference attribution_utils.pixel_distance :166-217)."""
    g = np.asarray(gen_images).reshape(len(gen_images), -1)
    t = np.asarray(train_images).reshape(len(train_images), -1)
    return cosine_similarity_matrix(g, t, device)


def embedding_similarity_scores(gen_embeddings: np.ndarray, train_embeddings: np.ndarray,
                                device="cuda") -> np.ndarray:
    """Embedding-space cosine similarity (the CLIPScore pattern :80-163)."""
    return cosine_similarity_matrix(gen_embeddings, train_embeddings, device)


def aggregate_by_class(
    scores: np.ndarray,
    labels: Sequence[int],
    agg: str = "mean",
    by: str = "max",
) -> np.ndarray:
    """(n_gen, n_train) scores -> per-group attributions.

    `by` collapses over generated images per train example (max/avg like the
    reference's grouped max/avg, text_to_image/pixel_similarity.py:213-245),
    then `agg` collapses train examples within each group.
    """
    labels = np.asarray(labels)
    per_train = scores.max(axis=0) if by == "max" else scores.mean(axis=0)
    groups = np.unique(labels)
    out = np.zeros(len(groups))
    for i, g in enumerate(groups):
        vals = per_train[labels == g]
        out[i] = vals.mean() if agg == "mean" else (
            vals.max() if agg == "max" else vals.sum()
        )
    return out


def sparsification_baseline(
    attrs: np.ndarray, labels: Sequence[int]
) -> Dict[int, float]:
    """Per-group attribution sums from per-example scores."""
    labels = np.asarray(labels)
    return {int(g): float(attrs[labels == g].sum()) for g in np.unique(labels)}
