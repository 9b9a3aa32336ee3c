"""INDEL 1-D U-Net (counterpart of ``mural_tpu/models/indel.py``; the
reference's UNet_Small, MuRaL/model/model_indel.py).

Six encoder levels with strides ``downsize[i]`` and widths
``out_channels * (i+1)``; each level is a strided Conv -> BN followed by
a residual inverted-bottleneck :class:`ConvBlock`.  The decoder mirrors
it with nearest upsampling -> Conv -> BN -> ConvBlock and additive skip
connections.  Head: two 1x1 convs (BN and ReLU between, Softplus after),
global max over length, BN -> Dropout(0.1) -> Linear -> Softplus.
Every BatchNorm is the port's ``BatchNorm1d`` (``ops/batch_norm.py``:
torch's keys and state, kernel K5 in train mode on a card).

``use_reverse`` adds the strand-symmetrised stem
``conv(x) + flip(conv(revcomp(x)))``: for the ACGT one-hot, flipping the
channel axis is complementation.  With distal track channels the input
has ``4 + n_cont`` channels: the stem (or, without it, the first encoder
conv) takes them all, and the stem's flip covers every channel, as in
the JAX package.

Module names give the reference's state_dict keys (``conv.0/.1``,
``uplblocks.i.0/.1``, ``upblocks.i.0.conv.N``, ``downlblocks.j.1/.2``,
``downblocks.j.0.conv.N``, ``out_conv.0/.1/.3``, ``out_fc.0/.2``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from mural_tpu_torch.ops.batch_norm import BatchNorm1d


def check_geometry(width: int, downsize: Sequence[int]) -> None:
    """Raise ``ValueError`` unless the decoder's skip connections align on
    a window of ``width`` bases: level 0 has ``ceil(width / s0)``
    positions, and each later stride must divide it in turn."""
    first = math.ceil(width / downsize[0])
    rest = math.prod(downsize[1:])
    if first % rest:
        raise ValueError(
            f"INDEL U-Net geometry: the window of {width} bases "
            f"(2 * --distal_radius) has ceil({width} / {downsize[0]}) = "
            f"{first} positions after the first level, which the later "
            f"--down_list strides {list(downsize[1:])} (product {rest}) do "
            "not divide, so the decoder's skip connections cannot align. "
            "Choose --distal_radius or --down_list so that they do "
            "(reference recipe: --distal_radius 4000 with --down_list "
            "1 4 5 5 5 2).")


class ConvBlock(nn.Module):
    """Residual inverted bottleneck: Conv(k=5, expand 2, no bias) -> BN ->
    SiLU -> Conv(1x1, no bias) -> BN, added to the input."""

    def __init__(self, channels: int, expand_ratio: int = 2):
        super().__init__()
        hidden = round(channels * expand_ratio)
        self.conv = nn.Sequential(
            nn.Conv1d(channels, hidden, 5, padding=2, bias=False),
            BatchNorm1d(hidden), nn.SiLU(),
            nn.Conv1d(hidden, channels, 1, bias=False),
            BatchNorm1d(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x)


class UpsampleNearest(nn.Module):
    """``nn.Upsample(scale_factor=scale, mode='nearest')`` on (N, C, L),
    done by ``repeat_interleave``: on an H100 its copies take a third of
    the time of ``upsample_nearest1d`` in the U-Net's forward (PERF.md
    section 6).  No parameters, so the state_dict keys are the same."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat_interleave(self.scale, dim=2)


class UNetSmall(nn.Module):
    """The INDEL model.  ``forward(cat, distal, cont=None)``: ``distal``
    is the (N, L, in_channels) one-hot (and track channels) with L = 2 *
    distal_radius; ``cat`` and ``cont`` are ignored (the SNV models'
    signature).  Output: softplus'd (N, n_class) scores, used as logits
    by the CE loss."""

    def __init__(self, n_class: int, out_channels: int, kernel_size: int,
                 downsize: Sequence[int], use_reverse: bool = False,
                 in_channels: int = 4):
        super().__init__()
        k, p = kernel_size, (kernel_size - 1) // 2
        self.downsize = tuple(int(s) for s in downsize)
        self.use_reverse = bool(use_reverse)
        if self.use_reverse:
            self.conv = nn.Sequential(
                nn.Conv1d(in_channels, 4, k, padding=p), BatchNorm1d(4))
        ch = [out_channels * (i + 1) for i in range(6)]
        self.uplblocks = nn.ModuleList(
            nn.Sequential(nn.Conv1d(c_in, c, k, stride=s, padding=p),
                          BatchNorm1d(c))
            for c_in, c, s in zip([4 if use_reverse else in_channels]
                                  + ch[:5], ch, self.downsize))
        self.upblocks = nn.ModuleList(nn.Sequential(ConvBlock(c))
                                      for c in ch)
        levels = range(4, -1, -1)          # the encoder level each joins
        self.downlblocks = nn.ModuleList(
            nn.Sequential(UpsampleNearest(self.downsize[lv + 1]),
                          nn.Conv1d(ch[lv + 1], ch[lv], k, padding=p),
                          BatchNorm1d(ch[lv]))
            for lv in levels)
        self.downblocks = nn.ModuleList(nn.Sequential(ConvBlock(ch[lv]))
                                        for lv in levels)
        self.out_conv = nn.Sequential(
            nn.Conv1d(ch[0], ch[0], 1), BatchNorm1d(ch[0]), nn.ReLU(),
            nn.Conv1d(ch[0], ch[0], 1), nn.Softplus())
        self.out_fc = nn.Sequential(BatchNorm1d(ch[0]), nn.Dropout(0.1),
                                    nn.Linear(ch[0], n_class))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The ``use_reverse`` stem on (N, C, L): the conv and BN on ``x``
        plus, flipped back along length, on ``x`` flipped along channels
        and length, its reverse complement for the one-hot (in train mode
        the BN's running statistics update once for each)."""
        return self.conv(x) + self.conv(x.flip(1, 2)).flip(2)

    def forward(self, cat: torch.Tensor, distal: torch.Tensor,
                cont=None) -> torch.Tensor:
        check_geometry(distal.shape[1], self.downsize)
        x = distal.transpose(1, 2)
        if self.use_reverse:
            x = self.stem(x)
        encodings = []
        for lblock, block in zip(self.uplblocks, self.upblocks):
            x = block(lblock(x))
            encodings.append(x)
        for lv, lblock, block in zip(range(4, -1, -1), self.downlblocks,
                                     self.downblocks):
            x = encodings[lv] + block(lblock(x))
        x = self.out_conv(x)
        # torch.max(dim) routes a tie's gradient to one index, as the
        # reference and the JAX package's VJP do (amax splits it)
        x = x.max(dim=2).values
        return nn.functional.softplus(self.out_fc(x))
