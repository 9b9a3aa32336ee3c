"""Dirichlet-family calibrators (counterpart of
``mural_tpu/calibrate/dirichlet.py``): FullDirichlet (log-clip transform
of the probabilities -> Full regression) and Temperature / Vector scaling
(FixDiag / Diag regressions with a grid search over the regularisers,
selected by log loss).

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


def _log_loss(y, probs) -> float:
    eps = np.finfo(probs.dtype).eps
    p = np.clip(probs, eps, 1 - eps)
    classes = np.unique(y)
    target = (np.asarray(y)[:, None] == classes[None, :])
    return float(np.mean(-np.log(np.sum(target * p, axis=1))))


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

    def fit(self, X, y, X_val=None, y_val=None):
        if X_val is None:
            X_val, y_val = X, y
        self.calibrator_ = MultinomialRegression(
            method="Full", reg_lambda=self.reg_lambda, reg_mu=self.reg_mu,
            reg_norm=self.reg_norm, ref_row=self.ref_row,
            optimizer=self.optimizer, weights_0=self.weights_init)
        self.calibrator_.fit(np.log(clip_for_log(np.copy(X))), y)
        self.final_loss_ = _log_loss(y_val, self.predict_proba(X_val))
        return self

    @property
    def weights_(self):
        return self.calibrator_.weights_

    @property
    def coef_(self):
        return self.calibrator_.coef_

    @property
    def intercept_(self):
        return self.calibrator_.intercept_

    def predict_proba(self, S):
        return self.calibrator_.predict_proba(np.log(clip_for_log(S)))

    predict = predict_proba


class _GridScaling:
    """Temperature/Vector scaling."""

    method = "FixDiag"

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

    def fit(self, X, y, X_val=None, y_val=None):
        if X_val is None:
            X_val, y_val = X, y
        _X, _X_val = self._transform(X), self._transform(X_val)
        best = None
        for lam in self.reg_lambda_list:
            for mu in self.reg_mu_list:
                cal = MultinomialRegression(method=self.method,
                                            reg_lambda=lam, reg_mu=mu,
                                            ref_row=self.ref_row)
                cal.fit(_X, y)
                loss = _log_loss(y_val, cal.predict_proba(_X_val))
                if best is None or loss < best[0]:
                    best = (loss, cal, lam, mu)
        self.final_loss_, self.calibrator_, self.reg_lambda, self.reg_mu = \
            best
        self.weights_ = self.calibrator_.weights_
        return self

    @property
    def coef_(self):
        return self.calibrator_.coef_

    @property
    def intercept_(self):
        return self.calibrator_.intercept_

    def predict_proba(self, S):
        return self.calibrator_.predict_proba(self._transform(S))

    predict = predict_proba


class TemperatureScaling(_GridScaling):
    method = "FixDiag"


class VectorScaling(_GridScaling):
    method = "Diag"
