"""Reference weight initialisation driven by a ``torch.Generator``
(counterpart of ``mural_tpu/models/init.py``).

The reference's ``weights_init`` (MuRaL/model/nn_utils.py:14-35):
Conv1d -> xavier_uniform, Linear -> kaiming_normal (fan_in, gain
sqrt(2)), biases 0.  Embeddings keep torch's N(0, 1); BatchNorm weight 1,
bias 0, running mean 0, running var 1.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise ``model`` in place and return it.  ``generator`` is a
    CPU generator: values are drawn on the CPU in module registration
    order and copied to the parameters' device, so one seed gives the
    same weights on every device."""
    for m in model.modules():
        if isinstance(m, nn.Conv1d):
            out_c, in_c, k = m.weight.shape
            a = math.sqrt(6.0 / (in_c * k + out_c * k))
            m.weight.copy_(
                torch.rand(m.weight.shape, generator=generator) * 2 * a - a)
            if m.bias is not None:      # the U-Net's ConvBlocks have none
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            std = math.sqrt(2.0 / m.weight.shape[1])
            m.weight.copy_(
                torch.randn(m.weight.shape, generator=generator) * std)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
    return model
