"""More calibrators of the reference's vendored ``dirichletcal`` package
(counterpart of ``mural_tpu/calibrate/extra.py``), on the port's
:class:`MultinomialRegression`:

- :class:`MatrixScaling`: a Full regression on raw logits;
- :class:`DiagDirichlet`: a Diag regression on log-probabilities;
- :class:`FixedDiagDirichlet`: a single-temperature (FixDiag) regression
  on log-probabilities;
- :class:`DirichletCalibrator`: the legacy facade that picks one by
  ``matrix_type``.

No CLI path uses them; their pickles load with
:func:`mural_tpu_torch.train.checkpoint.load_calibrator`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mural_tpu_torch.calibrate.dirichlet import clip_for_log
from mural_tpu_torch.calibrate.multinomial import MultinomialRegression


class _LogProbRegression:
    method = "Diag"
    _log_input = True

    def __init__(self, reg_lambda: float = 0.0,
                 reg_mu: Optional[float] = None, ref_row: bool = True,
                 optimizer: str = "auto"):
        self.reg_lambda = reg_lambda
        self.reg_mu = reg_mu
        self.ref_row = ref_row
        self.optimizer = optimizer
        self.calibrator_ = None

    def _transform(self, X):
        if self._log_input:
            return np.log(clip_for_log(np.copy(X)))
        return np.copy(X)

    def fit(self, X, y, *args, **kwargs):
        self.calibrator_ = MultinomialRegression(
            method=self.method, reg_lambda=self.reg_lambda,
            reg_mu=self.reg_mu, ref_row=self.ref_row,
            optimizer=self.optimizer)
        self.calibrator_.fit(self._transform(X), y)
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


class DiagDirichlet(_LogProbRegression):
    method = "Diag"


class FixedDiagDirichlet(_LogProbRegression):
    method = "FixDiag"


class MatrixScaling(_LogProbRegression):
    method = "Full"
    _log_input = False      # raw logits


class DirichletCalibrator:
    """The legacy facade (ref dirichletcal/__init__.py:14-120)."""

    def __init__(self, matrix_type: str = "full", l2: float = 0.0,
                 comp_l2: bool = False):
        if matrix_type not in ("full", "diagonal", "fixed_diagonal"):
            raise ValueError(f"invalid matrix_type {matrix_type}")
        self.matrix_type = matrix_type
        self.l2 = l2
        self.comp_l2 = comp_l2

    def fit(self, X, y, *args, **kwargs):
        from mural_tpu_torch.calibrate.dirichlet import \
            FullDirichletCalibrator
        if self.matrix_type == "full":
            mu = self.l2 if self.comp_l2 else None
            self.calibrator_ = FullDirichletCalibrator(
                reg_lambda=self.l2, reg_mu=mu)
        elif self.matrix_type == "diagonal":
            self.calibrator_ = DiagDirichlet(reg_lambda=self.l2)
        else:
            self.calibrator_ = FixedDiagDirichlet(reg_lambda=self.l2)
        self.calibrator_.fit(X, y)
        self.weights_ = self.calibrator_.weights_
        return self

    @property
    def coef_(self):
        return self.calibrator_.coef_

    def predict_proba(self, S):
        return self.calibrator_.predict_proba(S)

    predict = predict_proba
