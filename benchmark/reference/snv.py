"""Plain SNVNet2 (MuRaL's Network2, ``mural_snv --model_no 2``) in
torch's stock layers: the reference that the SNV cells' outputs are
judged against.

Local branch: a 5-wide embedding of each overlapping k-mer of the local
window, dropout, then ReLU(Linear) -> BatchNorm -> Dropout twice and a
linear head.  Two distal ResNet towers on the channels-first one-hot:
tower 1 on the +-100 bp centre crop with pools (3, 3, 1) x 3, tower 2 on
the whole window with pools (15, 15, 7), (7, 7, 3), (3, 3, 1); each is
BN -> Conv -> pool -> 2 pre-activation ResBlocks + skip -> pool -> BN ->
Conv -> 2 ResBlocks + skip -> pool -> BN -> Conv -> ReLU -> max over the
length, then BN -> Dropout -> Linear.  The output is the log of the mean
of the local softmax and the mean of the two tower softmaxes, clamped at
1e-9.  Parameter names are MuRaL's state_dict keys, so one dict of
weights loads into this module and into the measured program's.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

MID_POOLS = ((3, 3, 1), (3, 3, 1), (3, 3, 1))
LARGE_POOLS = ((15, 15, 7), (7, 7, 3), (3, 3, 1))


class ResBlock(nn.Module):
    def __init__(self, c: int, k: int = 3):
        super().__init__()
        self.bn1 = nn.BatchNorm1d(c)
        self.conv1 = nn.Conv1d(c, c, k, padding=(k - 1) // 2)
        self.bn2 = nn.BatchNorm1d(c)
        self.conv2 = nn.Conv1d(c, c, k, padding=(k - 1) // 2)

    def forward(self, x):
        out = self.conv1(self.bn1(F.relu(x)))
        out = self.conv2(self.bn2(F.relu(out)))
        return x + out


def _bn_conv(c_in, c_out, k, relu=False):
    layers = [nn.BatchNorm1d(c_in),
              nn.Conv1d(c_in, c_out, k, padding=(k - 1) // 2)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class SNVNet2(nn.Module):
    def __init__(self, cfg: dict, n_cat: int):
        super().__init__()
        k, c = cfg["CNN_kernel_size"], cfg["CNN_out_channels"]
        h1, h2 = cfg["local_hidden1_size"], cfg["local_hidden2_size"]
        n_class = cfg["n_class"]
        self.n_cat = n_cat
        self.emb_layer = nn.Embedding(4 ** cfg["local_order"] + 1, 5)
        self.emb_dropout_layer = nn.Dropout(cfg["emb_dropout"])
        self.lin_layers = nn.ModuleList(
            [nn.Linear(n_cat * 5, h1), nn.Linear(h1, h2)])
        self.bn_layers = nn.ModuleList(
            [nn.BatchNorm1d(h1), nn.BatchNorm1d(h2)])
        self.dropout_layers = nn.ModuleList(
            [nn.Dropout(cfg["local_dropout"]) for _ in range(2)])
        self.local_fc = nn.Sequential(nn.Linear(h2, n_class))
        for s in ("", "_2"):
            setattr(self, "conv1" + s, _bn_conv(4, c, k))
            setattr(self, "RBs1" + s, nn.Sequential(ResBlock(c), ResBlock(c)))
            setattr(self, "conv2" + s, _bn_conv(c, c, k))
            setattr(self, "RBs2" + s, nn.Sequential(ResBlock(c), ResBlock(c)))
            setattr(self, "conv3" + s, _bn_conv(c, c, k, relu=True))
        for name in ("distal_fc1", "distal_fc2"):
            setattr(self, name, nn.Sequential(
                nn.BatchNorm1d(c), nn.Dropout(cfg["distal_fc_dropout"]),
                nn.Linear(c, n_class)))

    def tower(self, x, s, pools):
        g = lambda name: getattr(self, name + s)       # noqa: E731
        x = F.max_pool1d(g("conv1")(x), *pools[0])
        x = x + g("RBs1")(x)
        x = F.max_pool1d(x, *pools[1])
        x = g("conv2")(x)
        x = x + g("RBs2")(x)
        x = F.max_pool1d(x, *pools[2])
        # the max routes the gradient to one position, as MuRaL's
        # torch.max(dim=2) does
        return torch.max(g("conv3")(x), dim=2).values

    def forward(self, cat, onehot):
        """``cat`` (n, n_cat) int64 k-mer ids, ``onehot`` (n, 4, L)."""
        x = self.emb_dropout_layer(self.emb_layer(cat).reshape(len(cat), -1))
        for lin, bn, drop in zip(self.lin_layers, self.bn_layers,
                                 self.dropout_layers):
            x = drop(bn(F.relu(lin(x))))
        local_p = torch.softmax(self.local_fc(x), 1)
        L = onehot.shape[2]
        crop = onehot[:, :, L // 2 - 100:L // 2 + 101]
        d1 = self.distal_fc1(self.tower(crop, "", MID_POOLS))
        d2 = self.distal_fc2(self.tower(onehot, "_2", LARGE_POOLS))
        distal_p = (torch.softmax(d1, 1) + torch.softmax(d2, 1)) / 2
        return torch.log(torch.clamp((local_p + distal_p) / 2, min=1e-9))
