"""Calibration quality metrics, numpy (counterpart of
``mural_tpu/calibrate/metrics.py``).

Parity with the reference's torch modules
(MuRaL/evaluation/evaluation.py:207-295): ECE / classwise ECE with
(lower, upper] bins over confidences, Brier score over re-softmaxed
pseudo-logits, and mean NLL.  The reference feeds ``log(probs)`` as
pseudo-logits and re-softmaxes inside each metric; these functions take
probabilities and renormalise the same way.
"""

from __future__ import annotations

import numpy as np


def _renorm(probs: np.ndarray) -> np.ndarray:
    # softmax(log p) == p / sum(p); replicate the reference's
    # log->softmax round-trip
    p = np.asarray(probs, np.float64)
    return p / p.sum(axis=1, keepdims=True)


def nll_from_probs(probs: np.ndarray, labels: np.ndarray) -> float:
    """Mean cross-entropy of log(probs) pseudo-logits
    (evaluation.py:339,345-352)."""
    p = _renorm(probs)
    picked = p[np.arange(len(labels)), labels]
    return float(np.mean(-np.log(picked)))


def ece(probs: np.ndarray, labels: np.ndarray, n_bins: int = 15) -> float:
    p = _renorm(probs)
    conf = p.max(axis=1)
    pred = p.argmax(axis=1)
    acc = (pred == labels).astype(np.float64)
    edges = np.linspace(0, 1, n_bins + 1)
    total = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        prop = in_bin.mean()
        if prop > 0:
            total += abs(conf[in_bin].mean() - acc[in_bin].mean()) * prop
    return float(total)


def classwise_ece(probs: np.ndarray, labels: np.ndarray,
                  n_bins: int = 15) -> float:
    p = _renorm(probs)
    k = int(labels.max()) + 1
    edges = np.linspace(0, 1, n_bins + 1)
    per_class = []
    for i in range(k):
        conf = p[:, i]
        in_class = (labels == i).astype(np.float64)
        sce = 0.0
        for lo, hi in zip(edges[:-1], edges[1:]):
            in_bin = (conf > lo) & (conf <= hi)
            prop = in_bin.mean()
            if prop > 0:
                sce += abs(conf[in_bin].mean()
                           - in_class[in_bin].mean()) * prop
        per_class.append(sce)
    return float(np.mean(per_class))


def brier_score(probs: np.ndarray, labels: np.ndarray) -> float:
    p = _renorm(probs)
    onehot = np.zeros_like(p)
    onehot[np.arange(len(labels)), labels] = 1.0
    return float(np.sum((onehot - p) ** 2) / p.shape[0])
