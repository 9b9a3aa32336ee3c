"""Plain NumPy of what a genome-wide map writes for each site: the softmax
of the model's output, the FullDirichlet calibration, the Poisson
calibration and the ``%.4g`` text of each probability."""

from __future__ import annotations

import numpy as np


def softmax(logits: np.ndarray) -> np.ndarray:
    z = np.asarray(logits, np.float64)
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def full_dirichlet(probs: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """softmax([log p, 1] @ W.T), ``W`` (k, k + 1), the log clipped to the
    smallest positive float64 as MuRaL's ``dirichletcal`` clips it."""
    tiny = np.finfo(np.float64).tiny
    s = np.log(np.clip(probs, tiny, 1 - tiny))
    return softmax(np.hstack([s, np.ones((len(s), 1))]) @ weights.T)


def poisson(probs: np.ndarray) -> np.ndarray:
    """lambda = -log p0; classes 1.. scaled by lambda / (1 - p0), p0 set
    to 1 - lambda."""
    p0 = probs[:, 0]
    lam = -np.log(p0)
    scale = np.where(p0 < 1, lam / np.where(p0 < 1, 1 - p0, 1), 0.0)
    out = probs * scale[:, None]
    out[:, 0] = 1 - lam
    return out


def as_written(values: np.ndarray) -> np.ndarray:
    """The float each value reads back as after ``%.4g``."""
    flat = [float("%.4g" % v) for v in np.asarray(values).ravel()]
    return np.asarray(flat, np.float64).reshape(np.shape(values))


def half_step(values: np.ndarray) -> np.ndarray:
    """Half the last-digit step of a ``%.4g`` number: the most that the
    rounding to four significant digits moves a value."""
    a = np.abs(np.asarray(values, np.float64))
    exp = np.floor(np.log10(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 0.5 * 10.0 ** (exp - 3), 0.0)


def excess_gap(written: np.ndarray, exact: np.ndarray,
               poisson: bool = False) -> float:
    """Largest gap between a written value and the exact one beyond what
    the ``%.4g`` rounding explains, relative to the exact value.  After
    the Poisson calibration column 0 holds 1 - lambda, a difference of
    numbers of order 1 that cancels near lambda = 1: its gap is taken
    relative to 1 where the value is smaller."""
    written = np.asarray(written, np.float64)
    exact = np.asarray(exact, np.float64)
    over = np.abs(written - exact) - half_step(written)
    scale = np.abs(exact)
    if poisson:
        scale = scale.copy()
        scale[:, 0] = np.maximum(scale[:, 0], 1.0)
    rel = np.maximum(over, 0) / np.maximum(scale, 1e-300)
    return float(rel.max()) if rel.size else 0.0
