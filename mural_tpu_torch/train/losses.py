"""Alternative losses (counterpart of ``mural_tpu/train/losses.py``; ref
MuRaL/evaluation/evaluation.py:367-487).

The reference defines FocalLoss, CBLoss and CB_loss but never wires them
into training (its loop uses ``CrossEntropyLoss(reduction='sum')``,
training.py:327), and neither does this package: they are plain
functions on tensors, run on the tensors' device and differentiable by
autograd.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def focal_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                  gamma: float = 0.0,
                  size_average: bool = False) -> torch.Tensor:
    """Multi-class focal loss on softmax log-probabilities (ref
    FocalLoss.forward, evaluation.py:373-387):
    ``loss_i = -(1 - p_t)^gamma * log p_t``, summed (or averaged)."""
    logpt = F.log_softmax(logits, dim=-1)
    logpt = logpt.gather(1, target[:, None].long())[:, 0]
    pt = logpt.exp()
    loss = -((1.0 - pt) ** gamma) * logpt
    return loss.mean() if size_average else loss.sum()


def _binary_ce_with_logits(logits, labels, weight=None):
    """Elementwise sigmoid BCE (``binary_cross_entropy_with_logits``
    with ``reduction='none'``), optionally weighted."""
    loss = -(labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))
    if weight is not None:
        loss = loss * weight
    return loss


def sigmoid_focal_loss(labels_one_hot: torch.Tensor, logits: torch.Tensor,
                       alpha: torch.Tensor, gamma: float) -> torch.Tensor:
    """Per-class sigmoid focal loss (ref focal_loss, evaluation.py:
    389-417): modulator * BCE, alpha-weighted, over the number of
    positive labels."""
    bc = _binary_ce_with_logits(logits, labels_one_hot)
    if gamma == 0.0:
        modulator = 1.0
    else:
        modulator = torch.exp(-gamma * labels_one_hot * logits
                              - gamma * torch.log1p(torch.exp(-logits)))
    weighted = alpha * modulator * bc
    return weighted.sum() / labels_one_hot.sum()


def class_balanced_loss(logits: torch.Tensor, labels: torch.Tensor,
                        samples_per_cls: Sequence[int],
                        n_class: int, loss_type: str = "sigmoid",
                        beta: float = 0.9999,
                        gamma: float = 1.0) -> torch.Tensor:
    """Class-balanced loss (ref CBLoss.forward, evaluation.py:427-449):
    class weights ``(1-beta)/(1-beta^n_c)`` normalised to sum to
    ``n_class``, given to each sample by its label."""
    effective_num = 1.0 - np.power(beta, np.asarray(samples_per_cls,
                                                    np.float64))
    weights = (1.0 - beta) / effective_num
    weights = weights / weights.sum() * n_class

    one_hot = F.one_hot(labels.long(), n_class).to(logits.dtype)
    w = torch.as_tensor(weights, dtype=logits.dtype,
                        device=logits.device)[None, :] * one_hot
    w = w.sum(dim=1, keepdim=True).expand_as(one_hot)

    if loss_type == "focal":
        return sigmoid_focal_loss(one_hot, logits, w, gamma)
    if loss_type == "sigmoid":
        return _binary_ce_with_logits(logits, one_hot, w).mean()
    if loss_type == "softmax":
        pred = F.softmax(logits, dim=1)
        eps = 1e-12
        bce = -(one_hot * torch.log(pred.clamp_min(eps))
                + (1 - one_hot) * torch.log((1 - pred).clamp_min(eps)))
        return (w * bce).mean()
    raise ValueError(f"unknown loss_type {loss_type!r}")
