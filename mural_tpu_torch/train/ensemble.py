"""Trial ensembles: T same-architecture trials trained as one vmapped
step (counterpart of ``mural_tpu/train/ensemble.py``).

The JAX package stacks T trials on a leading axis and ``jax.vmap``s the
device-resident epoch.  Here:

- :class:`EnsembleState` stacks the members' parameters and BatchNorm
  buffers with ``torch.func.stack_module_state`` (a leading T axis),
  and runs one member's model on its slice through
  ``torch.func.functional_call`` on a parameter-free copy of the model;
- :func:`ensemble_step_update` vmaps one member's forward and
  ``torch.func.grad`` over T, with ``randomness="different"`` (each
  member draws its own dropout masks); the BatchNorm modules update the
  members' running buffers in place on their batched slices;
- :class:`EnsembleOptimizer` clips each member's gradients to a norm of
  10 (torch's ``clip_grad_norm_``, +1e-6) and runs
  :class:`~mural_tpu_torch.train.optim.GraphOptimizer`'s update on the
  stacked tensors, each member at its own row of a ``(T, 4)`` scalars
  tensor (its LR and Adam's bias corrections, from its own host float64
  schedule: :func:`ensemble_epoch_scalars`, which replaces the JAX
  package's ``ScheduleArrays``) and its own weight decay; a ``live``
  mask freezes the parameters, optimizer state and buffers of a member
  that the scheduler stopped while the group trains on;
- the train data are one :class:`~mural_tpu_torch.train.resident.
  ResidentData` shared by all members, each member's epoch rows drawn
  from its own host generator: a step's rows are ``(T, B)``;
- the steps run in groups of K through
  :class:`~mural_tpu_torch.train.graphs.StepGroups`, one CUDA graph
  replay per group on the card, as a serial resident trial's do;
- :func:`ensemble_eval` runs validation for all members, vmapped over
  their parameters on the shared rows, in float32.

Members run the unfused model on the one-hot, as the JAX ensemble does:
the fused stem's kernels do not run under vmap.  Under ``bf16`` the
forward runs under the train step's bfloat16 autocast; the BatchNorm
modules of the vmapped model normalise in float32 and cast the result
(vmap's batch rule refuses a bfloat16 input with float32 affine
parameters, which the serial model's BatchNorm takes as it is).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad_and_value, stack_module_state
from torch.func import vmap

from mural_tpu_torch.ops import batch_norm
from mural_tpu_torch.train.optim import (BETAS, EPS, MOMENTUM,
                                         GraphOptimizer, LRSchedule,
                                         _check_name)
from mural_tpu_torch.train.steps import (GRAD_CLIP, masked_ce_sum,
                                         mixed_precision)


class _Float32BatchNorm(nn.BatchNorm1d):
    """BatchNorm1d that normalises in float32 and casts the result to the
    input's dtype (the JAX package's TorchBatchNorm on bfloat16)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


def functional_model(model: nn.Module) -> nn.Module:
    """A parameter-free copy of ``model`` (on the meta device) for
    ``functional_call``, its BatchNorm modules (torch's and the port's,
    whose kernel K5 does not run under vmap) normalising in float32."""
    base = copy.deepcopy(model).to("meta")
    for m in base.modules():
        if type(m) in (nn.BatchNorm1d, batch_norm.BatchNorm1d):
            m.__class__ = _Float32BatchNorm
    return base


def _per_member(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``(T,)`` -> broadcastable against a stacked ``(T, ...)`` tensor."""
    return x.view(-1, *([1] * (like.dim() - 1)))


class EnsembleOptimizer:
    """:class:`GraphOptimizer`'s update on stacked ``(T, ...)``
    parameters, preceded by each member's gradient clip.  ``scalars`` is
    a ``(T, 4)`` device tensor, one row of step scalars per member;
    ``weight_decay`` and ``live`` are ``(T,)``.  The arithmetic is
    GraphOptimizer's, in its order, with the member's weight decay as a
    tensor."""

    N_SCALARS = GraphOptimizer.N_SCALARS

    def __init__(self, name: str, params: Dict[str, torch.Tensor],
                 weight_decays: Sequence[float]):
        _check_name(name)
        self.name = name
        self.params = params
        first = next(iter(params.values()))
        T = first.shape[0]
        self.weight_decays = [float(w) for w in weight_decays]
        self.weight_decay = torch.tensor(self.weight_decays,
                                         dtype=torch.float32,
                                         device=first.device)
        self.scalars = torch.zeros((T, self.N_SCALARS), dtype=torch.float32,
                                   device=first.device)
        self.live = torch.ones(T, dtype=torch.bool, device=first.device)

        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}

        keys = (("momentum",) if name == "SGD" else
                ("exp_avg", "exp_avg_sq") if name == "Adam" else
                ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"))
        self.state = {key: zeros() for key in keys}

    def step_scalars(self, member: int, lr: float, t: int) -> tuple:
        """Member ``member``'s scalars of optimizer step ``t`` (1-based)
        at LR ``lr``: GraphOptimizer's."""
        if self.name == "SGD":
            return (lr, 0.0, 0.0, 0.0)
        return (lr, lr / (1 - BETAS[0] ** t), (1 - BETAS[1] ** t) ** 0.5,
                1 - lr * self.weight_decays[member])

    @torch.no_grad()
    def clip(self, grads: Dict[str, torch.Tensor]) -> None:
        """``clip_grad_norm_(..., 10)`` of each member, in place."""
        norms = torch.stack([g.flatten(1).norm(dim=1)
                             for g in grads.values()])           # (n, T)
        total = norms.norm(dim=0)                                # (T,)
        coef = torch.clamp(GRAD_CLIP / (total + 1e-6), max=1.0)
        for g in grads.values():
            g.mul_(_per_member(coef, g))

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """Clip and update every member; a member that is not live keeps
        its parameters and optimizer state."""
        self.clip(grads)
        lr, step_size, bc2_sqrt, decay = self.scalars.unbind(1)
        for key, p in self.params.items():
            g = grads[key]
            live = _per_member(self.live, p)
            wd = _per_member(self.weight_decay, p)
            state = {k: v[key] for k, v in self.state.items()}
            new = {}
            if self.name in ("Adam", "SGD"):          # L2 in the gradient
                g = torch.addcmul(g, p, wd)
            if self.name == "SGD":
                buf = state["momentum"] * MOMENTUM + g
                new["momentum"] = buf
                g = g + buf * MOMENTUM
                new_p = torch.addcmul(p, g, _per_member(lr, p), value=-1)
            else:
                q = p * _per_member(decay, p) if self.name != "Adam" else p
                m = torch.lerp(state["exp_avg"], g, 1 - BETAS[0])
                v = torch.addcmul(state["exp_avg_sq"] * BETAS[1], g, g,
                                  value=1 - BETAS[1])
                new["exp_avg"], new["exp_avg_sq"] = m, v
                if self.name != "Adam":               # amsgrad
                    v = torch.maximum(state["max_exp_avg_sq"], v)
                    new["max_exp_avg_sq"] = v
                denom = v.sqrt() / _per_member(bc2_sqrt, p) + EPS
                new_p = q - m * _per_member(step_size, p) / denom
            p.copy_(torch.where(live, new_p, p))
            for k, t in new.items():
                state[k].copy_(torch.where(live, t, state[k]))


class EnsembleState:
    """T stacked trials of one architecture: parameters and BatchNorm
    buffers with a leading T axis, the optimizer over them, each member's
    LR schedule and ROP learning rate.  ``step`` and ``epoch`` count for
    all members (they train in step); ``model`` is the parameter-free
    copy that ``functional_call`` runs."""

    def __init__(self, models: Sequence[nn.Module], optim_name: str,
                 weight_decays: Sequence[float],
                 schedules: Sequence[LRSchedule], bf16: bool = False):
        if not len(models) == len(weight_decays) == len(schedules):
            raise ValueError("ensemble member lists disagree in length")
        params, buffers = stack_module_state(list(models))
        self.params = {k: v.detach() for k, v in params.items()}
        self.buffers = buffers
        self.model = functional_model(models[0])
        self.optimizer = EnsembleOptimizer(optim_name, self.params,
                                           weight_decays)
        self.schedules = list(schedules)
        self.rop_lr = [s.base_lr for s in schedules]
        self.bf16 = bf16
        self.step = 0
        self.epoch = 0

    @property
    def n_members(self) -> int:
        return len(self.schedules)

    @property
    def live(self) -> torch.Tensor:
        return self.optimizer.live

    def member_state_dict(self, t: int) -> Dict[str, torch.Tensor]:
        """Member ``t``'s parameters and buffers, as a state_dict."""
        return {k: v[t] for k, v in (*self.params.items(),
                                     *self.buffers.items())}

    @torch.no_grad()
    def load_member_state(self, t: int, state: Dict[str, torch.Tensor]
                          ) -> None:
        """Copy a :meth:`member_state_dict` of member ``t`` back in."""
        for k, v in (*self.params.items(), *self.buffers.items()):
            v[t].copy_(state[k])


def ensemble_epoch_scalars(ens: EnsembleState, n_steps: int) -> np.ndarray:
    """``(n_steps, T, 4)`` float32 scalars of the epoch's next ``n_steps``
    optimizer steps, each member's from its own schedule and ROP LR (the
    host float64 values of ``train/graphs.py epoch_scalars``)."""
    opt = ens.optimizer
    rows = [[opt.step_scalars(
        t, s.lr_at(ens.step + i, ens.epoch, ens.rop_lr[t]),
        ens.step + i + 1) for t, s in enumerate(ens.schedules)]
        for i in range(n_steps)]
    return np.asarray(rows, dtype=np.float32).reshape(
        n_steps, ens.n_members, EnsembleOptimizer.N_SCALARS)


def _member_loss(model, params, buffers, y, cat, distal, mask, cont):
    logits = functional_call(model, (params, buffers), (cat, distal, cont))
    return masked_ce_sum(logits, y, mask)


def ensemble_step_update(ens: EnsembleState, y: torch.Tensor,
                         cat: torch.Tensor, distal: torch.Tensor,
                         mask: torch.Tensor,
                         cont=None) -> torch.Tensor:
    """One train step of every member on its own batch: ``y``, ``cat``,
    ``distal`` and ``cont`` lead with ``(T, B)``, ``mask`` ``(B,)`` is
    shared.  Forward and gradient vmapped over the members, then each
    member's clip and update at the scalars the optimizer holds; returns
    the members' losses ``(T,)`` on the device.  No host sync: a CUDA
    graph captures this."""
    model = ens.model
    model.train()
    buffers = {k: v.clone() for k, v in ens.buffers.items()}

    def member(params, buffers, y, cat, distal, cont):
        return grad_and_value(_member_loss, argnums=1)(
            model, params, buffers, y, cat, distal, mask, cont)

    with mixed_precision(y.device, ens.bf16):
        grads, losses = vmap(
            member, in_dims=(0, 0, 0, 0, 0, None if cont is None else 0),
            randomness="different")(ens.params, buffers, y, cat, distal,
                                    cont)
    ens.optimizer.step(grads)
    with torch.no_grad():
        live = ens.live
        for k, b in ens.buffers.items():
            b.copy_(torch.where(_per_member(live, b), buffers[k], b))
    return losses.detach()


def ensemble_batch(res, mask: torch.Tensor):
    """``batch(inputs, i)`` of a :class:`~mural_tpu_torch.train.graphs.
    StepGroups` over the members' resident rows: ``inputs`` is ``(rows
    (k, T, B),)``; step ``i`` gathers every member's rows ``rows[i]`` from
    the shared arena as the unfused one-hot, every mask 1."""
    def batch(inputs, i):
        rows = inputs[0][i]
        T, B = rows.shape
        y, cat, distal, cont = res.batch(rows.reshape(-1), False)

        def split(t):
            return None if t is None else t.reshape(T, B, *t.shape[1:])

        return split(y), split(cat), split(distal), mask, split(cont)

    return batch


@torch.no_grad()
def ensemble_eval(ens: EnsembleState, res, rows: torch.Tensor,
                  masks: torch.Tensor):
    """Validation of every member in float32 on the shared ``rows`` and
    ``masks`` ``(n_steps, B)``: ``(logits (T, n_steps, B, n_class),
    loss sums (T,))`` on the device."""
    model = ens.model
    model.eval()

    def forward(params, buffers, cat, distal, cont):
        return functional_call(model, (params, buffers), (cat, distal, cont))

    run = vmap(forward, in_dims=(0, 0, None, None, None))
    loss = vmap(masked_ce_sum, in_dims=(0, None, None))
    parts: List[torch.Tensor] = []
    total = torch.zeros(ens.n_members, dtype=torch.float32,
                        device=rows.device)
    for i in range(rows.shape[0]):
        y, cat, distal, cont = res.batch(rows[i], False)
        logits = run(ens.params, ens.buffers, cat, distal, cont)
        parts.append(logits)
        total += loss(logits, y, masks[i])
    logits = (torch.stack(parts, dim=1) if parts else None)
    return logits, total
