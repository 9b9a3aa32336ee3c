"""The train-mode BatchNorm work of one training window, counted from
its configuration's shapes: the elements of every BatchNorm over a 3-D
``(N, C, L)`` activation that kernel K5 normalises in a train step, and
their bytes at the least.  The counts follow the model, not an
implementation, so a redesigned kernel is held to the same work.

- U-Net: the ``use_reverse`` stem's BatchNorm(4), run twice; each of the
  six encoder levels' ``c`` and ``2c`` and ``c`` channels (the strided
  conv's BatchNorm, then the ConvBlock's two), the same for the five
  decoder levels; ``out_conv``'s BatchNorm.  The head's BatchNorm is 2-D.
- SNVNet2: each tower's BatchNorms after its stem: four at the first
  pooled length (the first two ResBlocks), five at the second (the
  second conv's and two ResBlocks'), one at the third.  The stem's
  BatchNorm is K2's under the fused stem, and K5's on the one-hot
  without it; the local branch's and the distal heads' are 2-D.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from harness.flops import (CROP, SNV_LARGE_POOLS, SNV_MID_POOLS, conv_len,
                           pool_len)

# float32 bytes an element at the least: x in, y out (forward); x and dy
# in, dx out (backward)
BYTES_PER_ELEMENT = 5 * 4


def unet_planes(cfg: Dict) -> List[Tuple[int, int]]:
    """(channels, length) of each BatchNorm call of one U-Net window."""
    k, c0 = cfg["CNN_kernel_size"], cfg["CNN_out_channels"]
    L = 2 * cfg["distal_radius"]
    ch = [c0 * (i + 1) for i in range(6)]
    planes = [(4, L)] * 2 if cfg["use_reverse"] else []
    lens, length = [], L
    for c, s in zip(ch, cfg["down_list"]):
        length = conv_len(length, k, s)
        lens.append(length)
        planes += [(c, length), (2 * c, length), (c, length)]
    for lv in range(4, -1, -1):
        planes += [(ch[lv], lens[lv]), (2 * ch[lv], lens[lv]),
                   (ch[lv], lens[lv])]
    planes.append((ch[0], lens[0]))
    return planes


def snv2_planes(cfg: Dict, fused_stem: bool) -> List[Tuple[int, int]]:
    """(channels, length) of each tower BatchNorm call of one SNVNet2
    window."""
    c = cfg["CNN_out_channels"]
    planes = []
    for length, pools in ((CROP, SNV_MID_POOLS),
                          (2 * cfg["distal_radius"] + 1, SNV_LARGE_POOLS)):
        if not fused_stem:
            planes.append((4, length))
        for pool, times in zip(pools, (4, 5, 1)):
            length = pool_len(length, *pool)
            planes += [(c, length)] * times
    return planes


def elements_per_window(cfg: Dict, traffic: Dict) -> int:
    """Elements that K5 normalises in one window's train step."""
    if cfg["reference"] == "unet":
        planes = unet_planes(cfg)
    else:
        planes = snv2_planes(cfg, traffic.get("fused_stem") == "on")
    return sum(c * n for c, n in planes)


def train_bytes(cfg: Dict, traffic: Dict, batch: int) -> float:
    """Least bytes of one train step's K5 work at ``batch`` windows."""
    return BYTES_PER_ELEMENT * batch * elements_per_window(cfg, traffic)
