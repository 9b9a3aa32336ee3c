"""Plain INDEL U-Net (MuRaL's UNet_Small, ``mural_indel``) in torch's
stock layers: the reference that the INDEL cells' outputs are judged
against.

Input: the channels-first one-hot ``(n, 4, W)`` of a ``W = 2 *
distal_radius`` window.  With ``use_reverse`` a stem ``BN(conv(x)) +
flip(BN(conv(revcomp(x))))`` (the reverse complement of a one-hot is its
flip over channels and length).  Six encoder levels of ``8 * (i + 1)``
channels: a strided Conv -> BN, then a residual inverted bottleneck
(Conv k5 x2 expand, no bias -> BN -> SiLU -> Conv 1x1 -> BN, added to
its input).  Five decoder levels: nearest upsampling -> Conv -> BN ->
bottleneck, added to the encoder level of the same length.  Head: Conv
1x1 -> BN -> ReLU -> Conv 1x1 -> Softplus, max over the length, BN ->
Dropout(0.1) -> Linear -> Softplus; the scores serve as logits.  Names
are MuRaL's state_dict keys.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class Bottleneck(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv1d(c, 2 * c, 5, padding=2, bias=False),
            nn.BatchNorm1d(2 * c), nn.SiLU(),
            nn.Conv1d(2 * c, c, 1, bias=False), nn.BatchNorm1d(c))

    def forward(self, x):
        return x + self.conv(x)


class Upsample(nn.Module):
    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class UNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        k, c0 = cfg["CNN_kernel_size"], cfg["CNN_out_channels"]
        p = (k - 1) // 2
        self.down = list(cfg["down_list"])
        self.use_reverse = bool(cfg["use_reverse"])
        if self.use_reverse:
            self.conv = nn.Sequential(nn.Conv1d(4, 4, k, padding=p),
                                      nn.BatchNorm1d(4))
        ch = [c0 * (i + 1) for i in range(6)]
        self.uplblocks = nn.ModuleList(
            nn.Sequential(nn.Conv1d(a, b, k, stride=s, padding=p),
                          nn.BatchNorm1d(b))
            for a, b, s in zip([4] + ch[:5], ch, self.down))
        self.upblocks = nn.ModuleList(nn.Sequential(Bottleneck(c))
                                      for c in ch)
        self.downlblocks = nn.ModuleList(
            nn.Sequential(Upsample(self.down[lv + 1]),
                          nn.Conv1d(ch[lv + 1], ch[lv], k, padding=p),
                          nn.BatchNorm1d(ch[lv]))
            for lv in range(4, -1, -1))
        self.downblocks = nn.ModuleList(nn.Sequential(Bottleneck(ch[lv]))
                                        for lv in range(4, -1, -1))
        self.out_conv = nn.Sequential(
            nn.Conv1d(ch[0], ch[0], 1), nn.BatchNorm1d(ch[0]), nn.ReLU(),
            nn.Conv1d(ch[0], ch[0], 1), nn.Softplus())
        self.out_fc = nn.Sequential(nn.BatchNorm1d(ch[0]), nn.Dropout(0.1),
                                    nn.Linear(ch[0], cfg["n_class"]))

    def forward(self, cat, onehot):
        """``onehot`` (n, 4, W); ``cat`` is not read."""
        x = onehot
        if self.use_reverse:
            x = self.conv(x) + torch.flip(self.conv(torch.flip(x, (1, 2))),
                                          (2,))
        levels = []
        for lblock, block in zip(self.uplblocks, self.upblocks):
            x = block(lblock(x))
            levels.append(x)
        for lv, lblock, block in zip(range(4, -1, -1), self.downlblocks,
                                     self.downblocks):
            x = levels[lv] + block(lblock(x))
        x = torch.max(self.out_conv(x), dim=2).values
        return F.softplus(self.out_fc(x))
