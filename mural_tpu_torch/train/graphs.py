"""K train steps per replay of one captured CUDA graph (counterpart of
``make_packed_train_step_scan``, ``mural_tpu/train/packed.py:202-255``).

The JAX package runs K train steps per dispatch as one ``lax.scan``; the
port records K eager steps into a CUDA graph and replays it, so the host
issues one replay where it issued every kernel of K steps.

- :func:`run_steps` is the code that the graph captures: step ``i``
  copies row ``i`` of a ``(k, 4)`` scalars tensor (the LR and Adam's bias
  corrections, :func:`epoch_scalars`) into the
  :class:`~mural_tpu_torch.train.optim.GraphOptimizer`'s ``scalars`` and
  runs :func:`~mural_tpu_torch.train.steps.step_update` on batch ``i`` of
  its inputs.  Nothing in it reads a tensor on the host.
- :class:`StepGroups` runs one group.  With K = 1 every step runs
  eagerly.  With K > 1 on a CUDA device the trial's
  first group of K runs eagerly on a side stream (real steps, which also
  upload every constant the step uses and set up cuBLAS and cuDNN), and
  the graph is captured after it on that stream, into a memory pool of
  its own, with ``capture_error_mode="thread_local"`` (trials of
  ``--n_parallel`` capture from threads of one process).  Later groups
  copy their inputs and scalars into the graph's static buffers and
  replay it.  A group shorter than K runs as eager single steps, as the
  JAX package's leftovers run its single step.  A capture or replay that
  fails raises with the step configuration; there is no eager fallback.
  On the CPU every group runs eagerly: the same code, which the tests
  hold against K single steps of torch's optimizers.
- The kernel launches a capture records (K2/K3, K5) count at each
  replay (``ops/_build.py captured_launches``).
- The step is :func:`~mural_tpu_torch.train.steps.step_update` by
  default; a trial ensemble passes its own
  (``train/ensemble.py ensemble_step_update``), whose scalars hold a
  row per member.  Under ``--bf16`` each step enters its bfloat16
  autocast without the cast cache, so a capture records every cast.
- Each group but the one that warms up and captures is a span
  (:mod:`mural_tpu_torch.utils.spans`): ``train.group`` with ``steps``
  and ``mode`` (``eager`` or ``replay``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mural_tpu_torch.ops._build import add_launches, captured_launches
from mural_tpu_torch.train.steps import TrainState, model_input, step_update
from mural_tpu_torch.utils import spans


def steps_per_dispatch(value: Optional[int], model_type: str,
                       profile_dir: Optional[str] = None) -> int:
    """K: ``None`` -> 8 for SNV, 1 for INDEL (whose step is device-bound);
    1 while profiling, so that the trace shows single steps
    (``mural_tpu/train/loop.py:431-436``)."""
    if profile_dir is not None:
        return 1
    if value is None:
        return 8 if model_type == "snv" else 1
    return max(1, value)


def epoch_scalars(state: TrainState, n_steps: int) -> np.ndarray:
    """``(n_steps, 4)`` float32 scalars of the epoch's next ``n_steps``
    optimizer steps (``state.step`` on): each LR from the schedule, the
    bias corrections from the step's 1-based count."""
    rows = [state.optimizer.step_scalars(
        state.schedule.lr_at(state.step + i, state.epoch, state.rop_lr),
        state.step + i + 1) for i in range(n_steps)]
    return np.asarray(rows, dtype=np.float32).reshape(n_steps, 4)


def host_fed_batch(fused_stem: bool) -> Callable:
    """``batch(inputs, i)`` of a :class:`StepGroups` over host-fed groups:
    ``inputs`` is ``(y, cat, codes, mask, cont, distal_tracks)``, each
    ``(k, B, ...)`` or None (``data/prefetch.py stacked_inputs``)."""
    def batch(inputs, i):
        y, cat, codes, mask, cont, tracks = (None if t is None else t[i]
                                             for t in inputs)
        return y, cat, model_input(codes, fused_stem, tracks), mask, cont

    return batch


def run_steps(state: TrainState, scalars: torch.Tensor, batch: Callable,
              inputs: tuple, step: Callable = step_update) -> torch.Tensor:
    """``len(scalars)`` train steps; ``batch(inputs, i)`` gives step i's
    ``(y, cat, distal, mask, cont)``.  Returns the losses ``(k, ...)``."""
    losses = []
    for i in range(scalars.shape[0]):
        state.optimizer.scalars.copy_(scalars[i])
        losses.append(step(state, *batch(inputs, i)))
    return torch.stack(losses)


class StepGroups:
    """Train steps in groups of ``k`` for one trial: one CUDA graph replay
    per group on a CUDA device when ``k > 1``, else eager steps.
    ``batch(inputs, i)`` reads step i's batch from a group's ``inputs``, a
    tuple of ``(k, ...)`` tensors (or None); ``step(state, *batch)`` runs
    one step."""

    def __init__(self, state: TrainState, k: int, batch: Callable,
                 step: Callable = step_update):
        self.state, self.k, self.batch, self.step = state, k, batch, step
        self.device = state.optimizer.scalars.device
        self.graph = None
        self.stream = None
        self.static = self.static_scalars = self.static_losses = None
        self.launches = {}          # kernel launches of one replay

    def describe(self) -> str:
        shapes = [None if t is None else tuple(t.shape) for t in self.static]
        return (f"{self.k} train steps of {type(self.state.model).__name__}"
                f" with {self.state.optimizer.name} on inputs {shapes}")

    def run(self, scalars: torch.Tensor, inputs: tuple) -> torch.Tensor:
        """Train on one group (``len(scalars)`` steps); returns the
        losses on the device and advances ``state.step``."""
        k = scalars.shape[0]
        if self.device.type != "cuda" or k != self.k or k == 1:
            with spans.span("train.group", key=self.state.step, steps=k,
                            mode="eager"):
                losses = run_steps(self.state, scalars, self.batch, inputs,
                                   self.step)
        else:
            with torch.cuda.device(self.device):
                if self.graph is None:
                    losses = self._warm_up_and_capture(scalars, inputs)
                else:
                    with spans.span("train.group", key=self.state.step,
                                    steps=k, mode="replay"):
                        losses = self._replay(scalars, inputs)
        self.state.step += k
        return losses

    def _warm_up_and_capture(self, scalars, inputs):
        current = torch.cuda.current_stream(self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            losses = run_steps(self.state, scalars, self.batch, inputs,
                               self.step)
            self.static = tuple(None if t is None else t.clone()
                                for t in inputs)
            self.static_scalars = scalars.clone()
        current.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        try:
            with captured_launches(self.stream) as tally, \
                    torch.cuda.graph(graph, stream=self.stream,
                                     capture_error_mode="thread_local"):
                self.static_losses = run_steps(
                    self.state, self.static_scalars, self.batch,
                    self.static, self.step)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of {self.describe()} "
                               f"failed: {e}") from e
        self.graph, self.launches = graph, tally
        return losses

    def _replay(self, scalars, inputs):
        for static, t in zip(self.static, inputs):
            if static is not None:
                static.copy_(t)
        self.static_scalars.copy_(scalars)
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph replay of {self.describe()} "
                               f"failed: {e}") from e
        add_launches(self.launches)
        return self.static_losses.clone()
