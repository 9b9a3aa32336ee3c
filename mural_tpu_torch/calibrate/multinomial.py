"""Multinomial (softmax) regression, prediction side (counterpart of
``mural_tpu/calibrate/multinomial.py:86-120``).

The fitted ``weights_`` (k, k+1) come from a calibrator pickle; fitting
(the damped Newton solver) is ported with the training slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class MultinomialRegression:
    def __init__(self, method: str = "Full", reg_lambda: float = 0.0,
                 reg_mu: Optional[float] = None, reg_norm: bool = False,
                 ref_row: bool = True, reg_format: Optional[str] = None,
                 optimizer: str = "auto", weights_0=None):
        self.method = method
        self.reg_lambda = reg_lambda
        self.reg_mu = reg_mu
        self.reg_norm = reg_norm
        self.ref_row = ref_row
        self.reg_format = reg_format
        self.optimizer = optimizer
        self.weights_0 = weights_0
        self.weights_ = None
        self.classes = None

    @property
    def coef_(self):
        return self.weights_[:, :-1]

    @property
    def intercept_(self):
        return self.weights_[:, -1]

    def predict_proba(self, S: np.ndarray) -> np.ndarray:
        S_ = np.hstack((S, np.ones((len(S), 1))))
        logits = S_ @ np.asarray(self.weights_).T
        logits = logits - logits.max(axis=1, keepdims=True)
        e = np.exp(logits)
        return e / e.sum(axis=1, keepdims=True)

    predict = predict_proba
