"""Data Banzhaf attribution.

Port of the JAX package's ``attributions/methods/databanzhaf.py`` (numpy,
bit-identical): least squares on {-1/2, +1/2}-shifted masks, whose
coefficients estimate the Banzhaf values of the game (Wang & Jia 2023).
"""

from __future__ import annotations

import numpy as np


def data_banzhaf(x_train: np.ndarray, y_train: np.ndarray) -> np.ndarray:
    """x_train: (n, d) 0/1 masks; y_train: (n,). Returns (d,) coefficients."""
    shifted = np.asarray(x_train, np.float64) - 0.5
    y = np.asarray(y_train, np.float64)
    coef, *_ = np.linalg.lstsq(shifted.T @ shifted, shifted.T @ y, rcond=None)
    return coef
