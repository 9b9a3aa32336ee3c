"""Plain training steps for the references: MuRaL's loss (cross-entropy
summed over the batch, the model's log-probabilities or scores taken as
logits), the gradient clipped to a total norm of 10, and torch's Adam
(L2 in the gradient) or AdamW (decoupled decay, amsgrad) written out.

Dropout draws its keep-mask in float32 from the device's default
generator, one draw per dropout layer in the order of the forward, so a
reference in float64 keeps the masks that a float32 run draws from the
same generator state.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

BETAS, EPS, CLIP = (0.9, 0.999), 1e-8, 10.0


class MaskDropout(nn.Module):
    """Dropout whose mask is drawn in float32 whatever the input's type."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        ones = torch.ones(x.shape, dtype=torch.float32, device=x.device)
        keep = nn.functional.dropout(ones, self.p, training=True)
        return x * keep.to(x.dtype)


def with_mask_dropout(model: nn.Module) -> nn.Module:
    """Swap every ``nn.Dropout`` of ``model`` for :class:`MaskDropout`."""
    for name, child in model.named_children():
        if isinstance(child, nn.Dropout):
            setattr(model, name, MaskDropout(child.p))
        else:
            with_mask_dropout(child)
    return model


def ce_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=1)
    return (logz - logits.gather(1, y[:, None])[:, 0]).sum()


class Adam:
    """torch's Adam (``AdamW``: decoupled decay and amsgrad) on a dict of
    leaves; ``seen`` keeps the gradient each step handed to the moments."""

    def __init__(self, params: Dict[str, torch.Tensor], name: str,
                 weight_decay: float):
        self.p, self.name, self.wd = params, name, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.vmax = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.seen: List[Dict[str, torch.Tensor]] = []

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2 = BETAS
        seen = {}
        for k, p in self.p.items():
            g = grads[k]
            if self.name == "Adam":
                g = g + self.wd * p
            else:
                p.mul_(1 - lr * self.wd)
            seen[k] = g.clone()
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            v = self.v[k]
            if self.name != "Adam":
                torch.maximum(self.vmax[k], v, out=self.vmax[k])
                v = self.vmax[k]
            denom = v.sqrt() / math.sqrt(1 - b2 ** self.t) + EPS
            p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.t))
        self.seen.append(seen)


def train_steps(model: nn.Module, opt: Adam, batches, lrs,
                loss_scale: float = 1.0) -> List[float]:
    """One step per ``(cat, onehot, y)`` batch at each LR: forward in train
    mode, the summed loss (times ``loss_scale``), backward, the clip, the
    update.  Returns the losses."""
    model.train()
    params = dict(model.named_parameters())
    losses = []
    for (cat, onehot, y), lr in zip(batches, lrs):
        for p in params.values():
            p.grad = None
        loss = ce_sum(model(cat, onehot), y) * loss_scale
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        norm = torch.sqrt(sum(g.pow(2).sum() for g in grads.values()))
        scale = min(1.0, CLIP / (float(norm) + 1e-6))
        opt.step({k: g * scale for k, g in grads.items()}, lr)
        losses.append(float(loss.detach()))
    return losses
