"""Train and eval steps (counterpart of ``mural_tpu/train/steps.py`` and
the packed single step of ``mural_tpu/train/packed.py``).

A train step (:func:`step_update`): forward in train mode (BN batch
statistics, dropout), masked CE-sum (the reference's
``CrossEntropyLoss(reduction='sum')``), backward, ``clip_grad_norm_(...,
10)``, then ``optimizer.step()`` at the LR the optimizer holds.  torch's
clip adds 1e-6 to the norm, optax's does not: when clipping fires the two
scale the gradient about 1e-7 apart.  In a data-parallel step each rank
runs this on its shard and the gradients are SUMmed over the ranks
between ``backward`` and the clip (``TrainState.grad_reduce``).

With ``bf16`` (``--bf16``, the JAX package's ``steps.py:39-60`` and
``packed.py:159-220``) the forward runs under a bfloat16
``torch.autocast``: the parameters stay float32 masters that the
autocast casts at use, so the gradients, the clip and the optimizer are
float32; the activations of convolutions and linear layers are bfloat16;
BatchNorm receives them and keeps float32 statistics and running
buffers; the fused stem runs its single-pass bf16 mode; the loss
reduction runs in float32.  Unlike the JAX package, which casts every
parameter to bfloat16, the embeddings, the BatchNorm affine and the
one-hot stay float32 (autocast leaves them), and the stem's table is
folded from the float32 parameters.  Validation runs in float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mural_tpu_torch.models.layers import one_hot_from_codes
from mural_tpu_torch.train.optim import LRSchedule

GRAD_CLIP = 10.0


def masked_ce_sum(logits: torch.Tensor, y: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Sum over valid rows of -(log_softmax(logits)[y]); the model's
    log-probabilities are re-normalised as logits, as the reference's
    CrossEntropyLoss does.  Reduces in float32 (at least) whatever the
    logits' dtype."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logz = torch.logsumexp(logits, dim=1)
    picked = logits.gather(1, y[:, None])[:, 0]
    return torch.sum((logz - picked) * mask)


def model_input(codes: torch.Tensor, fused_stem: bool,
                tracks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The distal input on the codes' device: the raw codes for the fused
    stem when there are no track channels; else the one-hot ``(N, L, 4)``
    with the per-base track values ``(N, L, n_tracks)`` after it."""
    if tracks is None:
        return codes if fused_stem else one_hot_from_codes(codes)
    onehot = one_hot_from_codes(codes)
    return torch.cat([onehot, tracks.to(onehot.dtype)], dim=-1)


class TrainState:
    """Model, optimizer and the LR bookkeeping of
    ``mural_tpu/train/state.py``: the global optimizer-step counter, the
    epoch counter and the ROP learning rate; ``bf16`` selects the mixed
    precision of the train steps."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, schedule: LRSchedule,
                 bf16: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.bf16 = bf16
        self.step = 0
        self.epoch = 0
        self.rop_lr = schedule.base_lr
        # data parallelism: SUMs the gradients over the ranks in place
        # (parallel/distributed.py RankContext.reduce_grads)
        self.grad_reduce = None

    def lr(self) -> float:
        return self.schedule.lr_at(self.step, self.epoch, self.rop_lr)


def mixed_precision(device: torch.device, bf16: bool):
    """The train step's autocast: bfloat16 when ``bf16``, else off.  Its
    cast cache is off, so that a CUDA graph captures every cast of a
    parameter in each of its steps."""
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16,
                          cache_enabled=False)


def step_update(state: TrainState, y: torch.Tensor, cat: torch.Tensor,
                distal: torch.Tensor, mask: torch.Tensor,
                cont: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward, backward, clip and the optimizer's update at the LR it
    holds; returns the loss on the device.  No host sync and no host
    counter: a CUDA graph captures this (``train/graphs.py``)."""
    model = state.model
    model.train()
    with mixed_precision(y.device, state.bf16):
        logits = model(cat, distal, cont)
    loss = masked_ce_sum(logits, y, mask)
    # every parameter's gradient: a transfer's frozen ones count in the
    # clip norm although the optimizer holds only the trainable ones
    model.zero_grad(set_to_none=True)
    loss.backward()
    if state.grad_reduce is not None:
        # before the clip: every rank clips by the global norm
        state.grad_reduce(model.parameters())
    torch.nn.utils.clip_grad_norm_(model.parameters(), GRAD_CLIP)
    state.optimizer.step()
    return loss.detach()


def train_step(state: TrainState, y: torch.Tensor, cat: torch.Tensor,
               distal: torch.Tensor, mask: torch.Tensor,
               cont: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, float]:
    """One step of a ``torch.optim`` optimizer at the schedule's float LR,
    the reference the tests and ``chip_smoke.py`` hold the loop's steps
    (``train/graphs.py``) against; returns (loss on the device, LR
    used)."""
    lr = state.lr()
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    loss = step_update(state, y, cat, distal, mask, cont)
    state.step += 1
    return loss, lr


@torch.no_grad()
def eval_step(model: torch.nn.Module, y: torch.Tensor, cat: torch.Tensor,
              distal: torch.Tensor, mask: torch.Tensor,
              cont: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode forward: (logits, masked loss sum), both on the device."""
    model.eval()
    logits = model(cat, distal, cont)
    return logits, masked_ce_sum(logits, y, mask)
