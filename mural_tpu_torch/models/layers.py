"""Building blocks of the SNV towers (counterpart of
``mural_tpu/models/layers.py:273-458``).

Layout is channels-first ``(N, C, L)``, as in the reference torch model;
torch's own ``Conv1d`` and ``MaxPool1d`` (-inf padding, floor length)
and ``BatchNorm1d`` (eps 1e-5; the port's subclass
:class:`~mural_tpu_torch.ops.batch_norm.BatchNorm1d`, which runs kernel
K5 in train mode on a card) carry the reference semantics, so none of
the JAX package's TPU workarounds are needed here.

A tower fed ``(N, L)`` uint8 codes instead of a one-hot runs its first
``BN -> Conv1d -> MaxPool1d`` as the fused stem :func:`fused_stem_pool`
(counterpart of ``FusedStemConvPool``, ``mural_tpu/models/layers.py:
338-382``) on the same ``conv1`` parameters and buffers.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mural_tpu_torch.ops.batch_norm import BatchNorm1d
from mural_tpu_torch.ops.fused_code_conv import fold_bn_conv_table
from mural_tpu_torch.ops.fused_train_stem import (code_conv_pool,
                                                  hist_batch_stats)
# the models' one-hot input, kernel K4 on CUDA tensors (re-exported)
from mural_tpu_torch.ops.window_one_hot import (  # noqa: F401
    one_hot_from_codes)

# (kernel, stride, padding) of the three pools of each tower
MID_POOLS = ((3, 3, 1), (3, 3, 1), (3, 3, 1))
LARGE_POOLS = ((15, 15, 7), (7, 7, 3), (3, 3, 1))

def BNConv(in_channels: int, out_channels: int, kernel_size: int,
           relu: bool = False) -> nn.Sequential:
    """BatchNorm -> Conv1d ('same' zero padding), optional trailing ReLU:
    the reference's ``conv1``/``conv2``/``conv3`` Sequentials."""
    layers = [BatchNorm1d(in_channels),
              nn.Conv1d(in_channels, out_channels, kernel_size,
                        padding=(kernel_size - 1) // 2)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class ResBlock(nn.Module):
    """Pre-activation residual block: ReLU->BN->Conv->ReLU->BN->Conv, the
    residual cropped to the conv output length."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        p = (kernel_size - 1) // 2
        self.bn1 = BatchNorm1d(channels)
        self.conv1 = nn.Conv1d(channels, channels, kernel_size, padding=p)
        self.bn2 = BatchNorm1d(channels)
        self.conv2 = nn.Conv1d(channels, channels, kernel_size, padding=p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(self.bn1(torch.relu(x)))
        out = self.conv2(self.bn2(torch.relu(out)))
        return x[:, :, :out.shape[2]] + out


def DistalFC(channels: int, n_class: int, dropout: float) -> nn.Sequential:
    """BN -> Dropout -> Linear head (keys ``.0`` and ``.2``)."""
    return nn.Sequential(BatchNorm1d(channels), nn.Dropout(dropout),
                         nn.Linear(channels, n_class))


class ResNetTower(nn.Module):
    """One distal tower: BN-Conv -> pool -> 2xResBlock + skip -> pool ->
    BN-Conv -> 2xResBlock + skip -> pool -> BN-Conv-ReLU -> global max.

    Attribute names are the reference's (``conv1``, ``RBs1``, ...);
    :class:`mural_tpu_torch.models.snv.DualTowers` registers two towers'
    layers flat under those names (tower 2 with a ``_2`` suffix)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, pools: Sequence[Sequence[int]]):
        super().__init__()
        for name, layer in tower_layers(in_channels, out_channels,
                                        kernel_size).items():
            setattr(self, name, layer)
        self.pools = tuple(tuple(p) for p in pools)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tower_forward(x, self.conv1, self.RBs1, self.conv2,
                             self.RBs2, self.conv3, self.pools)


def tower_layers(in_channels: int, out_channels: int,
                 kernel_size: int) -> dict:
    """The parameterised layers of one tower, by reference name."""
    c, k = out_channels, kernel_size
    return {
        "conv1": BNConv(in_channels, c, k),
        "RBs1": nn.Sequential(ResBlock(c), ResBlock(c)),
        "conv2": BNConv(c, c, k),
        "RBs2": nn.Sequential(ResBlock(c), ResBlock(c)),
        "conv3": BNConv(c, c, k, relu=True),
    }


def fused_stem_pool(conv1: nn.Sequential, codes: torch.Tensor,
                    pool: Sequence[int]) -> torch.Tensor:
    """``max_pool1d(conv1(one_hot(codes)), *pool)`` as the fused stem:
    (N, L) uint8 codes -> (N, C, P).

    In train mode the BN normalises with the histogram-exact batch
    statistics (constants, as the JAX package's ``stop_gradient``) and
    its running buffers follow torch's rule: ``0.9 * old + 0.1 * stat``
    with the unbiased variance, and ``num_batches_tracked`` counts up.
    So a fused-trained state_dict has the unfused one's keys and
    meaning.  Under data parallelism the BN is a
    :class:`~mural_tpu_torch.parallel.sync_bn.CrossRankBatchNorm` and the
    histogram is summed over the ranks.

    Under a bfloat16 autocast (``--bf16`` train steps) the stem runs the
    kernels' single-pass bf16 mode and returns bfloat16; the fold runs
    in float32 with autocast off, as the JAX package folds in float32
    (``mural_tpu/models/layers.py:373-377``), and the kernel rounds the
    finished table once."""
    bn, conv = conv1[0], conv1[1]
    pk, ps, pp = pool
    if ps != pk:
        raise ValueError("fused stem requires pool stride == kernel")
    if bn.training:
        # behind a cross-rank BN (parallel/sync_bn.py) the histogram is
        # the global batch's
        mean, var_b, var_u = hist_batch_stats(
            codes, getattr(bn, "reduce_counts", None))
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1 - m) * bn.running_var + m * var_u)
            bn.num_batches_tracked.add_(1)
        use_mean, use_var = mean, var_b
    else:
        use_mean, use_var = bn.running_mean, bn.running_var
    dev = codes.device.type
    with torch.autocast(dev, enabled=False):
        table, bias = fold_bn_conv_table(conv.weight, conv.bias, bn.weight,
                                         bn.bias, use_mean.detach(),
                                         use_var.detach(), bn.eps)
    return code_conv_pool(codes, table, bias, pk, pp, bf16=autocast_bf16(dev))


def autocast_bf16(device_type: str) -> bool:
    """Whether a bfloat16 autocast is on for ``device_type`` (the
    ``--bf16`` train step's mixed precision)."""
    return (torch.is_autocast_enabled(device_type)
            and torch.get_autocast_dtype(device_type) == torch.bfloat16)


def tower_forward(x: torch.Tensor, conv1: nn.Module, RBs1: nn.Module,
                  conv2: nn.Module, RBs2: nn.Module, conv3: nn.Module,
                  pools: Sequence[Sequence[int]]) -> torch.Tensor:
    """One tower's wiring: (N, C_in, L) one-hot or (N, L) uint8 codes
    (the fused stem) -> (N, C)."""
    if x.dim() == 2:
        x = fused_stem_pool(conv1, x, pools[0])
    else:
        x = nn.functional.max_pool1d(conv1(x), *pools[0])
    x = _skip(x, RBs1)
    x = nn.functional.max_pool1d(x, *pools[1])
    x = _skip(conv2(x), RBs2)
    x = nn.functional.max_pool1d(x, *pools[2])
    return torch.amax(conv3(x), dim=2)


def _skip(x: torch.Tensor, blocks: nn.Module) -> torch.Tensor:
    out = blocks(x)
    return x[:, :, :out.shape[2]] + out
