"""Dirichlet-family calibrators, prediction side (counterpart of
``mural_tpu/calibrate/dirichlet.py``).

Attribute layouts match the JAX package's and the reference's vendored
``dirichletcal`` classes (``calibrator_`` holding a
:class:`MultinomialRegression` with ``weights_``), so their pickles load
onto these classes (:func:`mural_tpu_torch.train.checkpoint.load_calibrator`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from mural_tpu_torch.calibrate.multinomial import MultinomialRegression


def clip_for_log(X: np.ndarray) -> np.ndarray:
    eps = np.finfo(np.asarray(X).dtype).tiny
    return np.clip(X, eps, 1 - eps)


class FullDirichletCalibrator:
    def __init__(self, reg_lambda: float = 0.0,
                 reg_mu: Optional[float] = None, weights_init=None,
                 initializer: str = "identity", reg_norm: bool = False,
                 ref_row: bool = True, optimizer: str = "auto"):
        self.reg_lambda = reg_lambda
        self.reg_mu = reg_mu
        self.weights_init = weights_init
        self.initializer = initializer
        self.reg_norm = reg_norm
        self.ref_row = ref_row
        self.optimizer = optimizer
        self.calibrator_ = None

    @classmethod
    def from_weights(cls, weights: np.ndarray) -> "FullDirichletCalibrator":
        """A calibrator with given (k, k+1) weights (no fitting)."""
        cal = cls()
        cal.calibrator_ = MultinomialRegression(method="Full")
        cal.calibrator_.weights_ = np.asarray(weights, np.float64)
        cal.calibrator_.classes = np.arange(len(weights))
        return cal

    @property
    def weights_(self):
        return self.calibrator_.weights_

    def predict_proba(self, S):
        return self.calibrator_.predict_proba(np.log(clip_for_log(S)))

    predict = predict_proba


class _GridScaling:
    """Temperature/Vector scaling, prediction side."""

    def __init__(self, reg_lambda_list: List[float] = [0.0],
                 reg_mu_list: List[Optional[float]] = [None],
                 logit_input: bool = False,
                 logit_constant: Optional[float] = None,
                 weights_init=None, initializer: str = "identity",
                 ref_row: bool = True):
        self.reg_lambda_list = reg_lambda_list
        self.reg_mu_list = reg_mu_list
        self.logit_input = logit_input
        self.logit_constant = logit_constant
        self.weights_init = weights_init
        self.initializer = initializer
        self.ref_row = ref_row
        self.calibrator_ = None

    def _transform(self, X):
        if self.logit_input:
            return np.copy(X)
        _X = np.log(clip_for_log(np.copy(X)))
        if self.logit_constant is None:
            return _X - _X[:, -1:].repeat(X.shape[1], axis=1)
        return _X - self.logit_constant

    def predict_proba(self, S):
        return self.calibrator_.predict_proba(self._transform(S))

    predict = predict_proba


class TemperatureScaling(_GridScaling):
    method = "FixDiag"


class VectorScaling(_GridScaling):
    method = "Diag"
