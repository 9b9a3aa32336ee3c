"""SNV network family (counterpart of ``mural_tpu/models/snv.py``; the
reference's Network0-3), numbered as ``--model_no``:

- ``SNVNet0``: the local-only feed-forward net over k-mer embeddings
  (``FeedForwardNN`` under the reference's ``model.`` key prefix); raw
  logits;
- ``SNVNet1``: the two distal ResNet towers only;
- ``SNVNet2``: local branch + both towers, probability-space averaged;
- ``SNVNet3``: SNVNet2 with a separate head for the continuous (track)
  features, three-way averaged.

The module tree and parameter names are the reference MuRaL state_dict
keys (``emb_layer``, ``first_bn_layer``, ``lin_layers.N``,
``bn_layers.N``, ``local_fc.0``, ``local_fc2.0/.2``, ``conv1.0/.1``,
``RBs1.0.bn1``, ``distal_fc1.0/.2``, tower 2 with a ``_2`` suffix), so
reference checkpoints load with ``load_state_dict`` once their duplicate
``*.layer.N.*`` keys and ``num_batches_tracked`` are dropped
(:func:`mural_tpu_torch.train.checkpoint.clean_state_dict`).  Layers on
the continuous features exist only when ``n_cont > 0``.

Every model is called as ``model(cat, distal, cont=None)``: ``cat (N, K)``
integer k-mer ids; ``distal`` either the ``(N, L, C)`` channels-last
one-hot with any track channels after its 4 (transposed once inside), or
``(N, L)`` uint8 genome codes, whose towers then run their first BN,
conv and pool as the fused stem (``layers.fused_stem_pool``); ``cont
(N, n_cont)`` float track means.  Outputs are log-probabilities
``log(clamp(mean of the heads' softmaxes, 1e-9))``, SNVNet0's raw
logits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mural_tpu_torch.models.layers import (LARGE_POOLS, MID_POOLS, DistalFC,
                                           tower_forward, tower_layers)

_EPS = 1e-9


def center_crop(x: torch.Tensor) -> torch.Tensor:
    """Tower 1's +-100 bp centre crop along the last axis."""
    L = x.shape[-1]
    return x[..., L // 2 - 100: L // 2 + 100 + 1]


def _log_mean(*probs: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(sum(probs) / len(probs), min=_EPS))


class LocalBranch(nn.Module):
    """Shared k-mer embedding + ReLU(Linear) -> BN -> Dropout trunk; with
    ``n_cont > 0`` the BN'd continuous features join the embeddings
    after their dropout."""

    def __init__(self, emb_vocab: int, n_cat: int,
                 lin_layer_sizes: Sequence[int], emb_dropout: float,
                 lin_layer_dropouts: Sequence[float], n_cont: int = 0):
        super().__init__()
        self._init_local(emb_vocab, n_cat, lin_layer_sizes, emb_dropout,
                         lin_layer_dropouts, n_cont)

    def _init_local(self, emb_vocab, n_cat, lin_layer_sizes, emb_dropout,
                    lin_layer_dropouts, n_cont=0):
        self.n_cat = n_cat
        self.n_cont = n_cont
        self.emb_layer = nn.Embedding(emb_vocab, 5)
        self.emb_dropout_layer = nn.Dropout(emb_dropout)
        if n_cont:
            self.first_bn_layer = nn.BatchNorm1d(n_cont)
        sizes = [n_cat * 5 + n_cont] + list(lin_layer_sizes)
        self.lin_layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.bn_layers = nn.ModuleList(
            nn.BatchNorm1d(s) for s in lin_layer_sizes)
        self.dropout_layers = nn.ModuleList(
            nn.Dropout(p) for p in lin_layer_dropouts)

    def forward_local(self, cat: torch.Tensor,
                      cont: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.emb_layer(cat).reshape(cat.shape[0], self.n_cat * 5)
        x = self.emb_dropout_layer(x)
        if self.n_cont:
            x = torch.cat([x, self.first_bn_layer(cont)], dim=1)
        for lin, bn, drop in zip(self.lin_layers, self.bn_layers,
                                 self.dropout_layers):
            x = drop(bn(torch.relu(lin(x))))
        return x

    forward = forward_local


class FeedForwardNN(LocalBranch):
    """The local branch and its output layer: raw logits."""

    def __init__(self, emb_vocab: int, n_cat: int,
                 lin_layer_sizes: Sequence[int], emb_dropout: float,
                 lin_layer_dropouts: Sequence[float], n_class: int,
                 n_cont: int = 0):
        nn.Module.__init__(self)
        self._init_local(emb_vocab, n_cat, lin_layer_sizes, emb_dropout,
                         lin_layer_dropouts, n_cont)
        self.output_layer = nn.Linear(lin_layer_sizes[-1], n_class)

    def forward(self, cat: torch.Tensor,
                cont: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.output_layer(self.forward_local(cat, cont))


class SNVNet0(nn.Module):
    """Local-only model: :class:`FeedForwardNN` under ``model.``; the
    distal input is ignored."""

    def __init__(self, emb_vocab: int, n_cat: int,
                 lin_layer_sizes: Sequence[int], emb_dropout: float,
                 lin_layer_dropouts: Sequence[float], n_class: int,
                 n_cont: int = 0):
        super().__init__()
        self.model = FeedForwardNN(emb_vocab, n_cat, lin_layer_sizes,
                                   emb_dropout, lin_layer_dropouts, n_class,
                                   n_cont)

    def forward(self, cat: torch.Tensor, distal=None,
                cont: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.model(cat, cont)


class DualTowers(nn.Module):
    """The two distal ResNet towers and their FC heads.  Tower 1 sees the
    +-100 bp centre crop with mid-scale pools, tower 2 the full window
    with large pools."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, distal_fc_dropout: float, n_class: int):
        super().__init__()
        self._init_towers(in_channels, out_channels, kernel_size,
                          distal_fc_dropout, n_class)

    def _init_towers(self, in_channels, out_channels, kernel_size,
                     distal_fc_dropout, n_class):
        self.in_channels = in_channels
        for suffix in ("", "_2"):
            for name, layer in tower_layers(in_channels, out_channels,
                                            kernel_size).items():
                setattr(self, name + suffix, layer)
        self.distal_fc1 = DistalFC(out_channels, n_class, distal_fc_dropout)
        self.distal_fc2 = DistalFC(out_channels, n_class, distal_fc_dropout)

    def _tower(self, x, suffix, pools):
        g = lambda name: getattr(self, name + suffix)
        return tower_forward(x, g("conv1"), g("RBs1"), g("conv2"),
                             g("RBs2"), g("conv3"), pools)

    def forward_towers(self, distal: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """distal (N, L, C) channels-last or (N, L) uint8 codes -> head
        logits (d1, d2)."""
        if distal.dim() == 2:
            if self.in_channels != 4:
                raise ValueError(
                    "codes input requires in_channels == 4 (no distal "
                    f"track channels), got {self.in_channels}")
            x = distal
        else:
            x = distal[:, :, :self.in_channels].transpose(1, 2)
        d1 = self.distal_fc1(self._tower(center_crop(x), "", MID_POOLS))
        d2 = self.distal_fc2(self._tower(x, "_2", LARGE_POOLS))
        return d1, d2

    def distal_probs(self, distal: torch.Tensor) -> torch.Tensor:
        """The mean of the two heads' softmaxes."""
        d1, d2 = self.forward_towers(distal)
        return (torch.softmax(d1, 1) + torch.softmax(d2, 1)) / 2

    forward = forward_towers


class SNVNet1(DualTowers):
    """Expanded-only model: both towers; ``cat`` and ``cont`` are
    ignored."""

    def forward(self, cat, distal: torch.Tensor, cont=None) -> torch.Tensor:
        return _log_mean(self.distal_probs(distal))


class SNVNet2(LocalBranch, DualTowers):
    """Local branch (with the continuous features when ``n_cont > 0``) +
    both towers, probability-space averaged."""

    def __init__(self, emb_vocab: int, n_cat: int,
                 lin_layer_sizes: Sequence[int], emb_dropout: float,
                 lin_layer_dropouts: Sequence[float], in_channels: int,
                 out_channels: int, kernel_size: int,
                 distal_fc_dropout: float, n_class: int, n_cont: int = 0):
        nn.Module.__init__(self)
        self._init_local(emb_vocab, n_cat, lin_layer_sizes, emb_dropout,
                         lin_layer_dropouts, n_cont)
        self.local_fc = nn.Sequential(
            nn.Linear(lin_layer_sizes[-1], n_class))
        self._init_towers(in_channels, out_channels, kernel_size,
                          distal_fc_dropout, n_class)

    def forward(self, cat: torch.Tensor, distal: torch.Tensor,
                cont: Optional[torch.Tensor] = None) -> torch.Tensor:
        local_p = torch.softmax(self.local_fc(self.forward_local(cat, cont)),
                                1)
        return _log_mean(local_p, self.distal_probs(distal))


class SNVNet3(SNVNet2):
    """SNVNet2 whose continuous features bypass the k-mer trunk: with
    ``n_cont > 0`` they get their own BN -> Dropout -> Linear head
    ``local_fc2`` and the output is the three-way average."""

    def __init__(self, emb_vocab: int, n_cat: int,
                 lin_layer_sizes: Sequence[int], emb_dropout: float,
                 lin_layer_dropouts: Sequence[float], in_channels: int,
                 out_channels: int, kernel_size: int,
                 distal_fc_dropout: float, n_class: int, n_cont: int = 0):
        # the k-mer trunk takes no continuous features here
        super().__init__(emb_vocab, n_cat, lin_layer_sizes, emb_dropout,
                         lin_layer_dropouts, in_channels, out_channels,
                         kernel_size, distal_fc_dropout, n_class, n_cont=0)
        self.n_cont_head = n_cont
        if n_cont:
            self.local_fc2 = nn.Sequential(
                nn.BatchNorm1d(n_cont), nn.Dropout(lin_layer_dropouts[0]),
                nn.Linear(n_cont, n_class))

    def forward(self, cat: torch.Tensor, distal: torch.Tensor,
                cont: Optional[torch.Tensor] = None) -> torch.Tensor:
        local_p = torch.softmax(self.local_fc(self.forward_local(cat)), 1)
        distal_p = self.distal_probs(distal)
        if not self.n_cont_head:
            return _log_mean(local_p, distal_p)
        cont_p = torch.softmax(self.local_fc2(cont), 1)
        return _log_mean(local_p, distal_p, cont_p)
