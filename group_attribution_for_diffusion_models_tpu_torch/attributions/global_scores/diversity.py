"""Demographic-diversity entropy (the CelebA global behavior).

The port's copy of the JAX package's ``attributions/global_scores/
diversity.py``, numpy and scipy, bit for bit (reference src/attributions/
global_scores/diversity_score.py:82-188): Ward-cluster the reference
embeddings (the BLIP-VQA vision tower in the reference, `models.blip_vision`
here, or any extractor) into `num_clusters`, assign each generated embedding
to the cluster with the smallest mean distance to that cluster's members,
and report the entropy of the resulting cluster proportions plus counts.
All of it runs on the host, in float64.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage


def ward_cluster(ref_embeddings: np.ndarray, num_clusters: int = 20) -> np.ndarray:
    """Ward hierarchical clustering; returns 0-based cluster ids."""
    z = linkage(np.asarray(ref_embeddings, np.float64), method="ward")
    return fcluster(z, t=num_clusters, criterion="maxclust") - 1


def assign_to_clusters(
    gen_embeddings: np.ndarray,
    ref_embeddings: np.ndarray,
    ref_clusters: np.ndarray,
) -> np.ndarray:
    """Nearest-cluster assignment by mean distance to cluster members
    (reference diversity_score.py:149-158)."""
    gen = np.asarray(gen_embeddings, np.float64)
    ref = np.asarray(ref_embeddings, np.float64)
    d = np.sqrt(
        np.maximum(
            (gen * gen).sum(1)[:, None]
            + (ref * ref).sum(1)[None, :]
            - 2.0 * gen @ ref.T,
            0.0,
        )
    )
    num_clusters = int(ref_clusters.max()) + 1
    mean_d = np.stack(
        [d[:, ref_clusters == c].mean(axis=1) for c in range(num_clusters)], axis=1
    )
    return mean_d.argmin(axis=1)


def diversity_entropy(
    cluster_assignments: np.ndarray, num_clusters: int
) -> Tuple[float, np.ndarray, np.ndarray]:
    """(entropy, counts, proportions) of generated-image cluster usage."""
    counts = np.bincount(cluster_assignments, minlength=num_clusters).astype(np.float64)
    proportions = counts / max(counts.sum(), 1.0)
    nonzero = proportions[proportions > 0]
    entropy = float(-(nonzero * np.log(nonzero)).sum())
    return entropy, counts, proportions


def calculate_diversity_score(
    ref_embeddings: np.ndarray,
    gen_embeddings: np.ndarray,
    num_clusters: int = 20,
) -> Dict:
    """End-to-end diversity behavior (reference diversity_score.py:82-188)."""
    ref_clusters = ward_cluster(ref_embeddings, num_clusters)
    assignments = assign_to_clusters(gen_embeddings, ref_embeddings, ref_clusters)
    entropy, counts, proportions = diversity_entropy(assignments, num_clusters)
    return {
        "entropy": entropy,
        "cluster_count": counts.tolist(),
        "cluster_proportions": proportions.tolist(),
        "assignments": assignments,
    }


def embedding_dist_to_mean(
    embeddings: np.ndarray, labels: np.ndarray
) -> Dict[int, float]:
    """Per-class mean L2 distance to the class centroid — the similarity
    baseline coefficient (reference diversity_score.py:191-234)."""
    out = {}
    for c in np.unique(labels):
        e = embeddings[labels == c]
        out[int(c)] = float(np.linalg.norm(e - e.mean(axis=0), axis=1).mean())
    return out
