"""Poisson calibration (counterpart of ``mural_tpu/calibrate/poisson.py``).

lambda = -log(prob0); the mutated-class probabilities are rescaled by
lambda / (1 - prob0) and prob0 becomes 1 - lambda.
"""

from __future__ import annotations

import numpy as np


def poisson_calibrate(probs: np.ndarray) -> np.ndarray:
    """(n, k) probabilities -> Poisson-calibrated float64 copy."""
    arr = np.array(probs, dtype=np.float64, copy=True)
    lam = -np.log(arr[:, 0])
    denom = 1.0 - arr[:, 0]
    scale = np.where(denom > 0, lam / np.where(denom > 0, denom, 1.0), 0.0)
    out = arr.copy()
    out[:, 1:] = arr[:, 1:] * scale[:, None]
    out[:, 0] = 1.0 - lam
    return out
