"""Inception Score from classifier logits.

The port's copy of the JAX package's
``attributions/global_scores/inception_score.py`` (numpy, the same
statements, so the scores are bit-identical): IS = exp(E_x KL(p(y|x) ||
p(y))) over `splits` chunks, with mean and std. It takes an (N,
num_classes) logit matrix, so the InceptionV3 forward stays separate.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def inception_score_from_logits(
    logits: np.ndarray, splits: int = 10
) -> Tuple[float, float]:
    logits = np.asarray(logits, dtype=np.float64)
    logits = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)

    # Fewer samples than splits would yield empty chunks (nan scores).
    splits = max(1, min(splits, len(probs)))
    scores = []
    for chunk in np.array_split(probs, splits):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = chunk * (np.log(chunk + 1e-16) - np.log(marginal + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    scores = np.asarray(scores)
    return float(scores.mean()), float(scores.std())
