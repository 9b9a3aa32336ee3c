"""BatchNorm over the global batch of a data-parallel step (the JAX
package gets it from XLA: its train-mode BatchNorm reduces over the
sharded batch axis of the mesh).

:class:`CrossRankBatchNorm` is ``nn.BatchNorm1d`` whose train-mode
statistics come from the per-channel sums, sums of squares and counts of
every rank's shard, reduced with the differentiable
``torch.distributed.nn.functional.all_reduce``: the gradients reach each
rank's inputs through the global statistics, as through one BatchNorm
on the whole batch.  The variance is the JAX package's ``E[x^2] -
E[x]^2``; the running variance is unbiased with the global count.  The
statistics are float32 (float64 for a float64 input) whatever the
input's dtype, and the reduced vector float64, so that counts stay
exact.  In eval mode it is plain ``nn.BatchNorm1d``.  Keys and meaning
of its state are ``nn.BatchNorm1d``'s, so a checkpoint written by a
data-parallel trial loads like one from one device.

``torch.nn.SyncBatchNorm`` is not used: it refuses CPU tensors, on which
the tests run two gloo ranks.

The fused stem (``models/layers.py fused_stem_pool``) reads its
statistics from the code histogram; behind a :class:`CrossRankBatchNorm`
it SUMs the histogram over the ranks first (:meth:`reduce_counts`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from mural_tpu_torch.ops import batch_norm


class CrossRankBatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with the global batch's statistics in train
    mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        from torch.distributed.nn.functional import all_reduce
        C = self.num_features
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        dims = [0, *range(2, x.dim())]
        local = torch.cat([xf.sum(dims), (xf * xf).sum(dims)]).double()
        count = torch.full((1,), x.numel() // C, dtype=torch.float64,
                           device=x.device)
        total = all_reduce(torch.cat([local, count]))
        n = total[-1]
        mean = total[:C] / n
        var = torch.clamp(total[C:2 * C] / n - mean * mean, min=0.0)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (self.momentum if self.momentum is not None
                     else 1.0 / self.num_batches_tracked.double())
                unbiased = var * (n / torch.clamp(n - 1, min=1))
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        shape = [1, C] + [1] * (x.dim() - 2)
        scale = torch.rsqrt(var.to(acc) + self.eps)
        if self.affine:
            scale = scale * self.weight.to(acc)
        y = (xf - mean.to(acc).view(shape)) * scale.view(shape)
        if self.affine:
            y = y + self.bias.to(acc).view(shape)
        return y.to(x.dtype)

    @staticmethod
    def reduce_counts(counts: torch.Tensor) -> torch.Tensor:
        """SUM an integer count vector over the ranks, in place."""
        dist.all_reduce(counts)
        return counts


def convert_batchnorm(model: nn.Module) -> nn.Module:
    """Swap every ``nn.BatchNorm1d`` of ``model``, the port's
    :class:`~mural_tpu_torch.ops.batch_norm.BatchNorm1d` included, for a
    :class:`CrossRankBatchNorm` that holds the same parameter and buffer
    tensors (an optimizer built before keeps them), in place; a module
    registered under two names stays one module."""
    swapped = {}
    for parent in list(model.modules()):
        # _modules, not named_children(), which yields a module once
        for name, child in list(parent._modules.items()):
            if type(child) not in (nn.BatchNorm1d, batch_norm.BatchNorm1d):
                continue
            if id(child) not in swapped:
                new = CrossRankBatchNorm(
                    child.num_features, child.eps, child.momentum,
                    child.affine, child.track_running_stats)
                for key, p in child.named_parameters(recurse=False):
                    setattr(new, key, p)
                for key, b in child.named_buffers(recurse=False):
                    setattr(new, key, b)
                new.train(child.training)
                swapped[id(child)] = new
            setattr(parent, name, swapped[id(child)])
    return model
