"""The plain reference of each configuration, by the name in its
``reference`` key."""

from __future__ import annotations

from torch import nn

from reference.indel import UNet
from reference.snv import SNVNet2


def build_reference(cfg: dict, n_cat: int) -> nn.Module:
    """The configuration's plain model, in float32 on the CPU."""
    if cfg["reference"] == "snv2":
        return SNVNet2(cfg, n_cat)
    if cfg["reference"] == "unet":
        return UNet(cfg)
    raise ValueError(f"no reference model {cfg['reference']!r}")
