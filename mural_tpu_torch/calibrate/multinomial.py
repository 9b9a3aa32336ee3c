"""Multinomial (softmax) regression with a damped-Newton solver
(counterpart of ``mural_tpu/calibrate/multinomial.py``), the numerical
core of Dirichlet calibration:

- log-prob features + a bias column -> softmax regression;
- Full / Diag / FixDiag weight parameterisations with an optional
  reference-row normalisation (subtract the last row);
- objective = mean NLL + L2 (or the ODIR off-diagonal/intercept) term;
- damped Newton: pseudo-inverse of the Hessian, then the first improving
  of 41 step sizes; ``scipy.optimize.fmin_l_bfgs_b`` for k > 36 classes.

The solver runs in float64 on the CPU with torch autograd, whatever
device trained the model; the fitted weights are numpy so the
calibrator pickles next to a checkpoint.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

logger = logging.getLogger(__name__)

_MAXITER = 1024
_FTOL = 1e-12
_GTOL = 1e-8
# 41 trial step sizes: 1 .. 0.1 linearly, then 1e-2 .. 1e-32 log-spaced
_STEPS = np.hstack((np.linspace(1, 0.1, 10), np.logspace(-2, -32, 31)))
_F64 = torch.float64


def _get_weights(params, k: int, ref_row: bool, method: str):
    if method in ("Full", None):
        raw = params.reshape(-1, k + 1)
    elif method == "Diag":
        raw = torch.hstack([torch.diag(params[:k]),
                            params[k:].reshape(-1, 1)])
    elif method == "FixDiag":
        raw = torch.hstack([torch.eye(k, dtype=_F64) * params[0],
                            torch.zeros((k, 1), dtype=_F64)])
    else:
        raise ValueError(f"Unknown calibration method {method}")
    if ref_row:
        raw = raw - raw[-1:, :]
    return raw


def _identity_init(k: int, method: str) -> np.ndarray:
    if method in ("Full", None):
        return np.hstack([np.eye(k), np.zeros((k, 1))]).ravel()
    if method == "Diag":
        return np.hstack([np.ones(k), np.zeros(k)])
    if method == "FixDiag":
        return np.ones(1)
    raise ValueError(method)


def _row_loss(z, t):
    """One sample's NLL as a function of its logits row (probabilities
    clipped to [eps, 1 - eps] of float64, as the reference)."""
    eps = torch.finfo(_F64).eps
    p = torch.clamp(torch.exp(torch.log_softmax(z, dim=-1)), eps, 1 - eps)
    return -torch.log(torch.sum(t * p, dim=-1))


def _reg_term(Wvec, k, reg_lambda, reg_mu, reg_format):
    """Regulariser as a function of vec(W) (post ref-row weights)."""
    W = Wvec.reshape(k, k + 1)
    zero_col = torch.zeros((k, 1), dtype=_F64)
    if reg_mu is None:
        reg = (torch.hstack([torch.eye(k, dtype=_F64), zero_col])
               if reg_format == "identity"
               else torch.zeros((k, k + 1), dtype=_F64))
        return reg_lambda * torch.sum((W - reg) ** 2)
    W_hat = W - torch.hstack([W[:, :-1] * torch.eye(k, dtype=_F64),
                              zero_col])
    return (reg_lambda * torch.sum(W_hat[:, :-1] ** 2)
            + reg_mu * torch.sum(W_hat[:, -1] ** 2))


def _objective(params, X, target, k, method, reg_lambda, reg_mu, ref_row,
               reg_format):
    W = _get_weights(params, k, ref_row, method)
    loss = torch.mean(_row_loss(X @ W.T, target))
    return loss + _reg_term(W.reshape(-1), k, reg_lambda, reg_mu,
                            reg_format)


def _newton_dir(weights, X, target, obj, k, method, ref_row, reg_args):
    """Gradient and pinv Newton direction.  The data term is
    row-separable, so with the linear map vec(W) = L @ params the
    Hessian is ``L.T @ (mean_i x_i x_i^T (x) B_i + H_reg) @ L``, with
    ``B_i`` the Hessian of sample i's loss in its own logits row: exact,
    assembled in the cheap order."""
    gradient = grad(obj)(weights)
    m, n = k + 1, X.shape[0]
    W = _get_weights(weights, k, ref_row, method)
    B = vmap(hessian(_row_loss))(X @ W.T, target)          # (n, k, k)
    XX = X[:, :, None] * X[:, None, :]                     # (n, m, m)
    H_W = (B.reshape(n, k * k).T @ XX.reshape(n, m * m)) / n
    H_W = (H_W.reshape(k, k, m, m).permute(0, 2, 1, 3)
           .reshape(k * m, k * m))
    H_W = H_W + hessian(lambda w: _reg_term(w, k, *reg_args))(W.reshape(-1))
    L = jacfwd(lambda p: _get_weights(p, k, ref_row, method)
               .reshape(-1))(weights)
    H = L.T @ H_W @ L
    if method == "FixDiag":
        return gradient, gradient / H[0, 0]
    # rcond of jnp.linalg.pinv: 10 * max(M, N) * eps
    rtol = 10 * H.shape[0] * torch.finfo(_F64).eps
    return gradient, torch.linalg.pinv(H, rtol=rtol) @ gradient


def _newton_solve(w0, X, target, method, *, k, reg_lambda, reg_mu,
                  ref_row, reg_format) -> np.ndarray:
    reg_args = (reg_lambda, reg_mu, reg_format)
    obj = partial(_objective, X=X, target=target, k=k, method=method,
                  reg_lambda=reg_lambda, reg_mu=reg_mu, ref_row=ref_row,
                  reg_format=reg_format)
    weights = torch.as_tensor(w0, dtype=_F64)
    steps = torch.as_tensor(_STEPS, dtype=_F64)
    L_list = [float(obj(weights))]
    for i in range(_MAXITER):
        gradient, updates = _newton_dir(weights, X, target, obj, k, method,
                                        ref_row, reg_args)
        if float(gradient.abs().sum()) < _GTOL:
            break
        # the reference's line search: the first step (largest to
        # smallest) that improves; if none improves, the last tried
        cand = weights[None, :] - steps[:, None] * updates[None, :]
        Ls = np.full(len(_STEPS), np.nan)
        idx = None
        for j in range(len(_STEPS)):
            Ls[j] = float(obj(cand[j]))
            if Ls[j] - L_list[-1] < 0:
                idx = j
                break
        if idx is None:
            idx = len(_STEPS) - 1
        tmp_w = cand[idx]
        L = float(Ls[idx])
        L_list.append(L)
        if np.isnan(L):
            logger.error("%s: log-loss is NaN", method)
            break
        if i >= 5:
            diffs = np.diff(L_list[-5:])
            if float(diffs.min()) > -_FTOL and float(diffs.sum()) <= 0:
                weights = tmp_w
                break
        if L_list[-1] - L_list[-2] > 0:
            break
        weights = tmp_w
    return weights.numpy()


class MultinomialRegression:
    def __init__(self, method: str = "Full", reg_lambda: float = 0.0,
                 reg_mu: Optional[float] = None, reg_norm: bool = False,
                 ref_row: bool = True, reg_format: Optional[str] = None,
                 optimizer: str = "auto", weights_0=None):
        if method not in ("Full", "Diag", "FixDiag"):
            raise ValueError(f"method {method} not available")
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

    def fit(self, X: np.ndarray, y: np.ndarray) -> "MultinomialRegression":
        X_ = torch.from_numpy(np.hstack((np.asarray(X, np.float64),
                                         np.ones((len(X), 1)))))
        self.classes = np.unique(y)
        k = len(self.classes)
        reg_lambda, reg_mu = self.reg_lambda, self.reg_mu
        if self.reg_norm:
            if reg_mu is None:
                reg_lambda = reg_lambda / (k * (k + 1))
            else:
                reg_lambda = reg_lambda / (k * (k - 1))
                reg_mu = reg_mu / k
        target = torch.from_numpy(
            (np.asarray(y)[:, None] == self.classes[None, :])
            .astype(np.float64))
        w0 = (np.asarray(self.weights_0, np.float64)
              if self.weights_0 is not None
              else _identity_init(k, self.method))
        statics = dict(k=k, method=self.method, reg_lambda=reg_lambda,
                       reg_mu=reg_mu, ref_row=self.ref_row,
                       reg_format=self.reg_format)
        if self.optimizer == "newton" or (self.optimizer == "auto"
                                          and k <= 36):
            weights = _newton_solve(w0, X_, target, self.method, **{
                key: v for key, v in statics.items() if key != "method"})
        elif self.optimizer == "fmin_l_bfgs_b" or (self.optimizer == "auto"
                                                   and k > 36):
            import scipy.optimize
            obj = partial(_objective, X=X_, target=target, **statics)

            def value_and_grad(w):
                w = torch.tensor(w, dtype=_F64, requires_grad=True)
                value = obj(w)
                value.backward()
                return float(value), w.grad.numpy().copy()

            weights = scipy.optimize.fmin_l_bfgs_b(
                func=value_and_grad, x0=w0, maxls=128, factr=1.0)[0]
        else:
            raise ValueError(f"Unknown optimizer: {self.optimizer}")
        self.weights_ = _get_weights(torch.as_tensor(weights, dtype=_F64),
                                     k, self.ref_row, self.method).numpy()
        return self
