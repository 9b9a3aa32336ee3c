"""Inputs made from ``--seed``: a genome of human base composition, the
sites and labels of a training set, the model's weights (on the device,
a few large draws) and the calibrator's.  One seed gives the same inputs
on every run; each kind of input draws from a stream of its own."""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import numpy as np
import torch
from torch import nn

# GRCh38's base composition outside N runs: 59% A+T
HUMAN_ACGT = (0.295, 0.205, 0.205, 0.295)


def stream(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for input ``tag`` of run ``seed``."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream(seed, tag))
    return g


def genome(seed: int, n_bases: int, device) -> np.ndarray:
    """(n_bases,) uint8 codes A C G T = 0 1 2 3 in human proportions,
    drawn on ``device``."""
    u = torch.rand(n_bases, generator=generator(seed, "genome", device),
                   device=device)
    edges = np.cumsum(HUMAN_ACGT)[:3].tolist()
    codes = sum((u >= e).to(torch.uint8) for e in edges)
    return codes.cpu().numpy()


def sites(seed: int, codes: np.ndarray, n_sites: int, focal: str,
          margin: int, mutated_share: float, n_class: int):
    """``n_sites`` training sites, positions ascending, at least
    ``margin`` bases from either end: SNV sites on the focal base ('+')
    or its complement ('-'), INDEL sites (``focal == 'all'``) anywhere on
    '+'.  A share ``mutated_share`` is labelled 1..n_class-1 evenly, the
    rest 0.  Returns (positions, negative-strand flags, labels)."""
    rng = np.random.default_rng(stream(seed, "sites"))
    inner = np.arange(margin, len(codes) - margin, dtype=np.int64)
    if focal == "all":
        pool, neg = inner, np.zeros(len(inner), bool)
    else:
        fwd = "ACGT".index(focal)
        rev = 3 - fwd
        keep = (codes[inner] == fwd) | (codes[inner] == rev)
        pool = inner[keep]
        neg = codes[pool] == rev
    if len(pool) < n_sites:
        raise ValueError(f"the genome holds {len(pool)} sites, "
                         f"{n_sites} asked for")
    pick = np.sort(rng.choice(len(pool), n_sites, replace=False))
    mutated = rng.random(n_sites) < mutated_share
    labels = np.where(mutated, rng.integers(1, n_class, n_sites), 0)
    return pool[pick], neg[pick], labels.astype(np.int32)


def _leaves(model: nn.Module):
    """(state_dict key, kind) of every float tensor of ``model``."""
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, nn.Conv1d):
            yield pre + "weight", "conv"
            if m.bias is not None:
                yield pre + "bias", "bias"
        elif isinstance(m, nn.Linear):
            yield pre + "weight", "linear"
            yield pre + "bias", "bias"
        elif isinstance(m, nn.Embedding):
            yield pre + "weight", "embedding"
        elif isinstance(m, nn.BatchNorm1d):
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                yield pre + leaf, "bn_" + leaf


@torch.no_grad()
def weights(model: nn.Module, seed: int, device,
            trained: bool) -> Dict[str, torch.Tensor]:
    """A state_dict for ``model`` drawn on ``device`` in two draws.

    Convolutions Xavier-uniform, linear layers Kaiming-normal,
    embeddings N(0, 1), as MuRaL initialises them.  Untrained
    (``trained=False``): biases 0 and BatchNorm at its reset.  Trained:
    small random biases and BatchNorm affine and running statistics
    spread as a trained model's are, so that folding them is exercised.
    """
    shapes = model.state_dict()
    leaves = list(_leaves(model))
    total = sum(shapes[k].numel() for k, _ in leaves)
    g = generator(seed, "weights", device)
    u = torch.rand(total, generator=g, device=device)
    z = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for key, kind in leaves:
        shape = shapes[key].shape
        n = shapes[key].numel()
        ui, zi = u[at:at + n].view(shape), z[at:at + n].view(shape)
        at += n
        if kind == "conv":
            c_out, c_in, k = shape
            a = math.sqrt(6.0 / (c_in * k + c_out * k))
            t = (2 * ui - 1) * a
        elif kind == "linear":
            t = zi * math.sqrt(2.0 / shape[1])
        elif kind == "embedding":
            t = zi
        elif not trained:
            t = (torch.ones_like(ui) if kind in ("bn_weight", "bn_running_var")
                 else torch.zeros_like(ui))
        elif kind == "bias":
            t = 0.05 * zi
        elif kind == "bn_weight":
            t = 0.5 + ui
        elif kind == "bn_bias":
            t = 0.2 * zi
        elif kind == "bn_running_mean":
            t = 0.2 * zi
        else:
            t = 0.5 + ui
        out[key] = t.float().contiguous()
    for key, v in shapes.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.long, device=device)
    return out


def calibrator_weights(seed: int, n_class: int) -> np.ndarray:
    """(k, k + 1) FullDirichlet weights near the identity."""
    rng = np.random.default_rng(stream(seed, "calibrator"))
    return (np.hstack([np.eye(n_class), np.zeros((n_class, 1))])
            + 0.1 * rng.normal(size=(n_class, n_class + 1)))
