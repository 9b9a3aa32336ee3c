"""Optimizers and learning-rate schedules (counterpart of
``mural_tpu/train/optim.py``).

- ``GraphOptimizer``, the optimizer of every train step of the loop:
  ``Adam`` with L2 in the gradient, ``AdamW`` / ``AdamW2`` with
  decoupled decay and amsgrad (the raw second moment maxed, the rule the
  JAX package re-implements), ``SGD`` with momentum 0.98 and Nesterov,
  as plain tensor ops whose LR (and Adam's bias corrections) come from a
  device tensor, so that a CUDA graph of K steps replays each at its own
  LR (``train/graphs.py``);
- ``build_optimizer``: torch's own optimizers with the same settings, at
  a float LR: the reference the tests and ``chip_smoke.py`` hold
  ``GraphOptimizer`` against;
- ``auto_weight_decay``: ``wd = 1 - wda ** (batch_size / (epochs *
  train_size))``;
- ``LRSchedule``: the LR of optimizer step ``step`` for StepLR, StepLR2
  and constant schedules, with the restart to ``restart_lr`` whenever
  the decayed LR would fall below ``min_lr``; pure Python, evaluated on
  the host for each step of an epoch;
- ``ReduceLROnPlateau``: stepped once per epoch with the validation loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import torch


def auto_weight_decay(weight_decay_auto: Optional[float], batch_size: int,
                      epochs: int, train_size: int,
                      weight_decay: float) -> float:
    if weight_decay_auto is not None and weight_decay_auto > 0:
        if weight_decay_auto >= 1:
            raise ValueError(
                "Please set a value smaller than 1 for --weight_decay_auto.")
        return 1 - weight_decay_auto ** (batch_size / (epochs * train_size))
    return weight_decay


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    """Per-step LR of torch StepLR chains with the restart rule."""
    kind: str                 # 'StepLR' | 'StepLR2' | 'ROP' | 'constant'
    base_lr: float
    gamma: float = 0.9
    step_size: int = 1
    restart_lr: float = 1e-4
    min_lr: float = 1e-6
    steps_per_epoch: int = 1

    @classmethod
    def build(cls, name: str, learning_rate: float, LR_gamma: float,
              batch_size: int, train_size: int, restart_lr: float,
              min_lr: float) -> "LRSchedule":
        steps_per_epoch = max(train_size // batch_size, 1)
        if name == "StepLR":
            return cls("StepLR", learning_rate, LR_gamma,
                       max((5000 * 128) // batch_size, 1), restart_lr,
                       min_lr, steps_per_epoch)
        if name == "StepLR2":
            gamma = (min_lr / restart_lr) ** (1.0 / steps_per_epoch)
            return cls("StepLR2", learning_rate, gamma, 1, restart_lr,
                       min_lr, steps_per_epoch)
        if name == "ROP":
            return cls("ROP", learning_rate, 0.2, 1, restart_lr, min_lr,
                       steps_per_epoch)
        if name == "constant":
            return cls("constant", learning_rate, 1.0, 1, restart_lr,
                       min_lr, steps_per_epoch)
        raise ValueError(
            f"unsupported lr_scheduler {name!r}; choose StepLR, StepLR2 "
            "or ROP")

    def _first_below(self, start: float) -> int:
        """Smallest j >= 0 with start * gamma**j < min_lr."""
        if self.gamma >= 1.0 or start < self.min_lr:
            return 0 if start < self.min_lr else 2 ** 30
        x = math.log(self.min_lr / start) / math.log(self.gamma)
        return max(int(math.floor(x)) + 1, 0)

    def _phase_lr(self, decays: int, start: float) -> float:
        """LR after ``decays`` gamma-steps from ``start``; whenever the
        decayed LR would fall below min_lr it restarts at restart_lr."""
        j0 = self._first_below(start)
        if decays < j0:
            return start * self.gamma ** decays
        jr = max(self._first_below(self.restart_lr), 1)
        return self.restart_lr * self.gamma ** ((decays - j0) % jr)

    def lr_at(self, step: int, epoch: int,
              rop_lr: Optional[float] = None) -> float:
        """LR of optimizer step ``step`` (0-based, global).  torch steps
        the scheduler after each optimizer step, so step k sees k //
        step_size decays; StepLR2 restarts from restart_lr at every epoch
        after the first."""
        if self.kind == "ROP":
            return rop_lr
        if self.kind == "constant":
            return self.base_lr
        if self.kind == "StepLR":
            return self._phase_lr(step // self.step_size, self.base_lr)
        decays = step - epoch * self.steps_per_epoch
        return self._phase_lr(decays, self.base_lr if epoch == 0
                              else self.restart_lr)


class ReduceLROnPlateau:
    """torch's ReduceLROnPlateau with the reference's settings: mode min,
    factor 0.2, patience 1, relative threshold 1e-4, min_lr 1e-7; the
    bad-epoch counter resets after every reduction."""

    def __init__(self, init_lr: float, factor: float = 0.2,
                 patience: int = 1, threshold: float = 1e-4,
                 min_lr: float = 1e-7):
        self.lr = float(init_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr


BETAS, EPS, MOMENTUM = (0.9, 0.999), 1e-8, 0.98
OPTIMIZERS = ("Adam", "AdamW", "AdamW2", "SGD")


def _check_name(name: str) -> None:
    if name not in OPTIMIZERS:
        raise ValueError(f"unsupported optimization method {name}")


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                    weight_decay: float) -> torch.optim.Optimizer:
    """torch's named optimizer at lr 0 (the reference of
    :class:`GraphOptimizer`); ``steps.train_step`` sets each step's LR
    from the schedule before ``optimizer.step()``."""
    _check_name(name)
    params = list(params)
    if name == "Adam":
        return torch.optim.Adam(params, lr=0.0, betas=BETAS, eps=EPS,
                                weight_decay=weight_decay)
    if name in ("AdamW", "AdamW2"):
        return torch.optim.AdamW(params, lr=0.0, betas=BETAS, eps=EPS,
                                 weight_decay=weight_decay, amsgrad=True)
    return torch.optim.SGD(params, lr=0.0, momentum=MOMENTUM, nesterov=True,
                           weight_decay=weight_decay)


class GraphOptimizer:
    """``build_optimizer``'s update as plain tensor ops that read the
    step's scalars from the device tensor ``scalars``: the LR, Adam's
    step size ``lr / (1 - beta1**t)`` and ``sqrt(1 - beta2**t)``, and
    AdamW's decay ``1 - lr * weight_decay``.  The host computes them in
    float64, as torch's optimizers do (:meth:`step_scalars`), and a step
    copies its row in first, so a captured CUDA graph replays every step
    at its own LR.  torch's optimizers cannot serve here: a float LR is
    baked into the graph, SGD reads a tensor LR on the host, and
    capturable Adam refuses CPU tensors, on which the tests run this
    code.  State and arithmetic are torch's single-tensor updates', in
    their order of operations (bit-equal on the CPU; SGD's momentum
    buffer starts at zero, which makes its first step torch's copy of the
    gradient)."""

    N_SCALARS = 4

    def __init__(self, name: str, params: Iterable[torch.nn.Parameter],
                 weight_decay: float):
        _check_name(name)
        self.name = name
        self.params = list(params)
        self.weight_decay = weight_decay
        self.scalars = torch.zeros(self.N_SCALARS, dtype=torch.float32,
                                   device=self.params[0].device)

        def zeros():
            return [torch.zeros_like(p) for p in self.params]

        if name == "SGD":
            self.state = {"momentum": zeros()}
        else:
            self.state = {"exp_avg": zeros(), "exp_avg_sq": zeros()}
            if name != "Adam":
                self.state["max_exp_avg_sq"] = zeros()

    def step_scalars(self, lr: float, t: int) -> tuple:
        """The scalars of optimizer step ``t`` (1-based) at LR ``lr``."""
        if self.name == "SGD":
            return (lr, 0.0, 0.0, 0.0)
        return (lr, lr / (1 - BETAS[0] ** t), (1 - BETAS[1] ** t) ** 0.5,
                1 - lr * self.weight_decay)

    @torch.no_grad()
    def step(self) -> None:
        """One update of the parameters that have a gradient."""
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        params = [self.params[i] for i in live]
        grads = [self.params[i].grad for i in live]
        state = {k: [v[i] for i in live] for k, v in self.state.items()}
        lr, step_size, bc2_sqrt, decay = self.scalars.unbind()
        wd = self.weight_decay
        if wd and self.name in ("Adam", "SGD"):       # L2 in the gradient
            grads = torch._foreach_add(grads, params, alpha=wd)
        if self.name == "SGD":
            buf = state["momentum"]
            torch._foreach_mul_(buf, MOMENTUM)
            torch._foreach_add_(buf, grads)
            grads = torch._foreach_add(grads, buf, alpha=MOMENTUM)
            # p - lr * g in one rounding, as torch's add_(alpha=-lr)
            torch._foreach_addcmul_(params, grads, [lr] * len(params),
                                    value=-1)
            return
        if wd and self.name != "Adam":                # decoupled decay
            torch._foreach_mul_(params, decay)
        m, v = state["exp_avg"], state["exp_avg_sq"]
        torch._foreach_lerp_(m, grads, 1 - BETAS[0])
        torch._foreach_mul_(v, BETAS[1])
        torch._foreach_addcmul_(v, grads, grads, 1 - BETAS[1])
        if self.name != "Adam":                       # amsgrad
            torch._foreach_maximum_(state["max_exp_avg_sq"], v)
            v = state["max_exp_avg_sq"]
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, bc2_sqrt)
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_mul(m, step_size)
        torch._foreach_div_(update, denom)
        torch._foreach_sub_(params, update)
