"""Optimizers and learning-rate schedules (counterpart of
``mural_tpu/train/optim.py``).

- optimizers (``build_optimizer``): ``Adam`` with L2 in the gradient,
  ``AdamW`` / ``AdamW2`` as ``torch.optim.AdamW(amsgrad=True)`` (torch
  maxes the raw second moment, the rule the JAX package re-implements),
  ``SGD`` with momentum 0.98 and Nesterov;
- ``auto_weight_decay``: ``wd = 1 - wda ** (batch_size / (epochs *
  train_size))``;
- ``LRSchedule``: the LR of optimizer step ``step`` for StepLR, StepLR2
  and constant schedules, with the restart to ``restart_lr`` whenever
  the decayed LR would fall below ``min_lr``; pure Python, evaluated by
  the train step before each ``optimizer.step()``;
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


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                    weight_decay: float) -> torch.optim.Optimizer:
    """The named optimizer at lr 0; the train step sets each step's LR
    from the schedule before ``optimizer.step()``."""
    params = list(params)
    if name == "Adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
    if name in ("AdamW", "AdamW2"):
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay,
                                 amsgrad=True)
    if name == "SGD":
        return torch.optim.SGD(params, lr=0.0, momentum=0.98,
                               nesterov=True, weight_decay=weight_decay)
    raise ValueError(f"unsupported optimization method {name}")
