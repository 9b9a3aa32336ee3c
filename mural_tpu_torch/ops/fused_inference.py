"""BN-folded fused inference forward for SNVNet2 (counterpart of
``mural_tpu/ops/fused_inference.py``).

Eval-mode BatchNorm is a per-channel affine, so every BN folds into the
conv or dense layer after it:

- ``BN -> Conv``:  W'[o,c,k] = W[o,c,k] * a_c, plus the d-term below
- ``BN -> Dense``: W'[o,c]   = W[o,c] * a_c,   b'_o = b_o + sum_c W*d_c
- each tower's stem (one-hot -> BN -> conv) becomes the lookup table of
  the CUDA kernel :func:`mural_tpu_torch.ops.fused_code_conv.code_conv1d`

with a = gamma / sqrt(var + eps) and d = beta - mean * a.  The convs
after the stem, the pools and the dense heads stay ``F.conv1d``,
``F.max_pool1d`` and ``F.linear``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from mural_tpu_torch.models.layers import LARGE_POOLS, MID_POOLS
from mural_tpu_torch.models.snv import SNVNet2, center_crop
from mural_tpu_torch.ops.fused_code_conv import (code_conv1d,
                                                 fold_bn_conv_table)

_EPS = 1e-9


def _affine(bn: torch.nn.BatchNorm1d):
    a = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return a, bn.bias - bn.running_mean * a


def _fold_conv(bn: torch.nn.BatchNorm1d, conv: torch.nn.Conv1d) -> Dict:
    """BN -> Conv fold.  Zero padding comes AFTER the BN in the
    reference, so the folded d-term differs in the first and last ``pad``
    positions (padded taps contribute 0, not W*d): the raw kernel and d
    are kept so the forward adds the exact per-position d-term."""
    a, d = _affine(bn)
    return {"weight": conv.weight * a[None, :, None], "bias": conv.bias,
            "raw": conv.weight, "d": d, "pad": conv.padding[0]}


def _fold_dense(bn: torch.nn.BatchNorm1d, lin: torch.nn.Linear):
    """BN -> Dense fold; torch weight layout (out, in)."""
    a, d = _affine(bn)
    return lin.weight * a[None, :], lin.bias + lin.weight @ d


def _conv1d_folded(x: torch.Tensor, fc: Dict) -> torch.Tensor:
    pad = fc["pad"]
    out = F.conv1d(x, fc["weight"], fc["bias"], padding=pad)
    # exact BN d-term incl. edge effects: convolve a constant d map with
    # the raw kernel under the same zero padding
    d_map = fc["d"][None, :, None].expand(1, -1, x.shape[2])
    return out + F.conv1d(d_map, fc["raw"], padding=pad)


@torch.no_grad()
def fold_snv2(model: SNVNet2) -> Dict:
    """Pre-fold every SNVNet2 parameter for inference (on the model's
    device)."""
    folded = {"emb": model.emb_layer.weight}
    lins = list(model.lin_layers)
    bns = list(model.bn_layers)
    # lin_i -> relu -> bn_i -> (next): bn_i folds into the NEXT dense
    folded["lin"] = [(lins[0].weight, lins[0].bias)] + [
        _fold_dense(bns[i - 1], lins[i]) for i in range(1, len(lins))]
    folded["local_fc"] = _fold_dense(bns[-1], model.local_fc[0])
    for suffix, tower in (("", "tower1"), ("_2", "tower2")):
        g = lambda name: getattr(model, name + suffix)
        bn, conv = g("conv1")[0], g("conv1")[1]
        ft = {"stem": fold_bn_conv_table(
            conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
            bn.running_var, bn.eps)}
        for name in ("conv2", "conv3"):
            ft[name] = _fold_conv(g(name)[0], g(name)[1])
        for group in ("RBs1", "RBs2"):
            ft[group] = [{"c1": _fold_conv(rb.bn1, rb.conv1),
                          "c2": _fold_conv(rb.bn2, rb.conv2)}
                         for rb in g(group)]
        folded[tower] = ft
    folded["distal_fc1"] = _fold_dense(model.distal_fc1[0],
                                       model.distal_fc1[2])
    folded["distal_fc2"] = _fold_dense(model.distal_fc2[0],
                                       model.distal_fc2[2])
    return folded


def _resblocks(x: torch.Tensor, blocks) -> torch.Tensor:
    """Two pre-activation ResBlocks plus the tower's skip connection."""
    jump = x
    for rb in blocks:
        out = _conv1d_folded(torch.relu(x), rb["c1"])
        out = _conv1d_folded(torch.relu(out), rb["c2"])
        x = x[:, :, :out.shape[2]] + out
    return jump[:, :, :x.shape[2]] + x


def _tower(codes: torch.Tensor, ft: Dict, pools) -> torch.Tensor:
    table, bias = ft["stem"]
    # the kernel keeps the JAX layout (B, L, C); the convs want (B, C, L)
    x = code_conv1d(codes, table, bias).transpose(1, 2)
    x = F.max_pool1d(x, *pools[0])
    x = _resblocks(x, ft["RBs1"])
    x = F.max_pool1d(x, *pools[1])
    x = _resblocks(_conv1d_folded(x, ft["conv2"]), ft["RBs2"])
    x = F.max_pool1d(x, *pools[2])
    return torch.amax(torch.relu(_conv1d_folded(x, ft["conv3"])), dim=2)


def snv2_fused_forward(folded: Dict, cat: torch.Tensor,
                       codes: torch.Tensor) -> torch.Tensor:
    """Fused eval forward: (cat (N, K) int64, codes (N, L) uint8) ->
    log-probabilities equal to ``SNVNet2.eval()(cat, one_hot(codes))``."""
    local = folded["emb"][cat].reshape(cat.shape[0], -1)
    for weight, bias in folded["lin"]:
        local = torch.relu(F.linear(local, weight, bias))
    local = F.linear(local, *folded["local_fc"])

    d1 = _tower(center_crop(codes), folded["tower1"], MID_POOLS)
    d2 = _tower(codes, folded["tower2"], LARGE_POOLS)
    d1 = F.linear(d1, *folded["distal_fc1"])
    d2 = F.linear(d2, *folded["distal_fc2"])

    distal_p = (torch.softmax(d1, 1) + torch.softmax(d2, 1)) / 2
    local_p = torch.softmax(local, 1)
    return torch.log(torch.clamp((local_p + distal_p) / 2, min=_EPS))
