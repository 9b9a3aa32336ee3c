"""The work a cell does, counted from its configuration's shapes: model
FLOPs per window (forward, and forward + backward for training) and the
bytes and operations of the kernels K1, K2 and K3.  The counts follow
the algorithm, not an implementation, so a redesigned kernel is held to
the same work.  A multiply-add is 2 FLOPs; normalisation, activations
and pooling are not counted.

Published peaks of one NVIDIA H100 SXM (data sheet, dense): 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM, at a 700 W limit.
The measured program runs float32 with TF32 off, so 67 TFLOP/s is the
peak its FLOPs are set against.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

SNV_MID_POOLS = ((3, 3, 1), (3, 3, 1), (3, 3, 1))
SNV_LARGE_POOLS = ((15, 15, 7), (7, 7, 3), (3, 3, 1))
CROP = 201          # tower 1's centre crop of the SNV window


def pool_len(L: int, k: int, s: int, p: int) -> int:
    return (L + 2 * p - k) // s + 1


def conv_len(L: int, k: int, s: int = 1) -> int:
    """Output length of a 'same'-padded convolution of stride ``s``."""
    return (L + 2 * ((k - 1) // 2) - k) // s + 1


# a layer: (FLOPs of its forward per window, whether its input carries a
# gradient in training, i.e. the backward computes a data gradient too)
Layer = Tuple[float, bool]


def _conv(c_in, c_out, k, L_out, grad_in=True) -> Layer:
    return 2.0 * c_in * c_out * k * L_out, grad_in


def snv2_layers(cfg: Dict) -> List[Layer]:
    """SNVNet2's layers at the configuration's window."""
    k, c = cfg["CNN_kernel_size"], cfg["CNN_out_channels"]
    h1, h2, n = (cfg["local_hidden1_size"], cfg["local_hidden2_size"],
                 cfg["n_class"])
    n_cat = 2 * cfg["local_radius"] + 1 - cfg["local_order"] + 1
    # the first linear layer's data gradient reaches the embedding
    layers = [(2.0 * n_cat * 5 * h1, True), (2.0 * h1 * h2, True),
              (2.0 * h2 * n, True)]
    L = 2 * cfg["distal_radius"] + 1
    for length, pools in ((CROP, SNV_MID_POOLS), (L, SNV_LARGE_POOLS)):
        layers.append(_conv(4, c, k, length, grad_in=False))
        length = pool_len(length, *pools[0])
        layers += [_conv(c, c, 3, length)] * 4
        length = pool_len(length, *pools[1])
        layers += [_conv(c, c, k, length)] + [_conv(c, c, 3, length)] * 4
        length = pool_len(length, *pools[2])
        layers += [_conv(c, c, k, length), (2.0 * c * n, True)]
    return layers


def unet_layers(cfg: Dict) -> List[Layer]:
    """The INDEL U-Net's layers at the configuration's window."""
    k, c0, n = cfg["CNN_kernel_size"], cfg["CNN_out_channels"], cfg["n_class"]
    down = cfg["down_list"]
    L = 2 * cfg["distal_radius"]
    ch = [c0 * (i + 1) for i in range(6)]
    layers = []
    if cfg["use_reverse"]:
        layers += [_conv(4, 4, k, L, grad_in=False)] * 2
    lens, c_in, length = [], 4, L
    for i, (c, s) in enumerate(zip(ch, down)):
        length = conv_len(length, k, s)
        lens.append(length)
        layers.append(_conv(c_in, c, k, length,
                            grad_in=i > 0 or cfg["use_reverse"]))
        layers += [_conv(c, 2 * c, 5, length), _conv(2 * c, c, 1, length)]
        c_in = c
    for lv in range(4, -1, -1):
        layers.append(_conv(ch[lv + 1], ch[lv], k, lens[lv]))
        layers += [_conv(ch[lv], 2 * ch[lv], 5, lens[lv]),
                   _conv(2 * ch[lv], ch[lv], 1, lens[lv])]
    layers += [_conv(ch[0], ch[0], 1, lens[0])] * 2
    layers.append((2.0 * ch[0] * n, True))
    return layers


LAYERS = {"snv2": snv2_layers, "unet": unet_layers}


def forward_flops(cfg: Dict) -> float:
    """Model FLOPs of one window's forward."""
    return sum(f for f, _ in LAYERS[cfg["reference"]](cfg))


def train_flops(cfg: Dict) -> float:
    """Model FLOPs of one window's training step: the forward, the weight
    gradient of every layer and the data gradient of every layer whose
    input needs one."""
    return sum(f * (3 if grad_in else 2)
               for f, grad_in in LAYERS[cfg["reference"]](cfg))


def least_seconds(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """Least time for moving ``n_bytes`` and doing ``n_ops`` float32
    operations on the card, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def stem_shapes(cfg: Dict) -> List[Tuple[int, int, int]]:
    """(L, pool kernel, pool padding) of the SNV towers' two stems: tower
    2 on the whole window, tower 1 on the crop."""
    L = 2 * cfg["distal_radius"] + 1
    (pk2, _, pp2), (pk1, _, pp1) = SNV_LARGE_POOLS[0], SNV_MID_POOLS[0]
    return [(L, pk2, pp2), (CROP, pk1, pp1)]


def k1_work(cfg: Dict, B: int) -> Tuple[float, float]:
    """(bytes, ops) of one predict batch's two K1 calls (eval BN + conv as
    a table lookup): uint8 codes in, the (k, 16, C) table and bias in,
    the (B, L, C) float32 output out; k adds per output."""
    k, C = cfg["CNN_kernel_size"], cfg["CNN_out_channels"]
    n_bytes = n_ops = 0.0
    for L, _, _ in stem_shapes(cfg):
        n_bytes += B * L + B * L * C * 4 + (k * 16 * C + C) * 4
        n_ops += B * L * C * k
    return n_bytes, n_ops


def _stem_calls(cfg: Dict):
    for L, pk, pp in stem_shapes(cfg):
        P = pool_len(L, pk, pk, pp)
        conv_positions = min(L + pp, P * pk) - pp
        yield L, P, conv_positions


def k2_work(cfg: Dict, B: int) -> Tuple[float, float]:
    """(bytes, ops) of one train step's two K2 calls (train BN + conv +
    max pool): codes, table and bias in, the pooled (B, C, P) float32 and
    its uint8 argmax out; k tap adds and one compare per conv output."""
    k, C = cfg["CNN_kernel_size"], cfg["CNN_out_channels"]
    n_bytes = n_ops = 0.0
    for L, P, lv in _stem_calls(cfg):
        n_bytes += B * L + B * C * P * 5 + (k * 16 * C + C) * 4
        n_ops += B * lv * C * (k + 1)
    return n_bytes, n_ops


def k3_work(cfg: Dict, B: int) -> Tuple[float, float]:
    """(bytes, ops) of one train step's two K3 calls (the table's
    gradient): codes, the uint8 argmax and the float32 gradient of the
    pooled output in, the (k, 16, C) table gradient out; k adds per
    pooled output."""
    k, C = cfg["CNN_kernel_size"], cfg["CNN_out_channels"]
    n_bytes = n_ops = 0.0
    for L, P, _ in _stem_calls(cfg):
        n_bytes += B * L + B * C * P * 5 + k * 16 * C * 4
        n_ops += B * C * P * k
    return n_bytes, n_ops
