"""Fused one-hot + BatchNorm + first convolution of a distal tower
(counterpart of ``mural_tpu/ops/fused_code_conv.py``).

Because one-hot selects rows of a 15x4 table and eval-mode BN is a
per-channel affine, the stem collapses into a per-tap lookup table:

    T[k, code, c_out] = sum_c W[c_out, c, k] * (OHE[code, c] * a_c + d_c)
    out[b, l, :]      = bias + sum_k T[k, codes_padded[b, l + k], :]

with a = gamma / sqrt(var + eps), d = beta - mean * a, and a zero
sentinel row (code 15) that implements the conv's zero padding.

:func:`code_conv1d` runs the hand-written CUDA kernel
``csrc/code_conv1d.cu`` on CUDA tensors (see the note there for what
bounds it and how it is laid out), cut over the card by
:func:`k1_launch_plan`, and the plain PyTorch version
:func:`code_conv1d_reference` on CPU tensors.  The kernel is built with
``nvcc`` for ``sm_90a`` at first use into ``build/kernels/`` at the root
of the checkout and loaded with ``ctypes`` (:mod:`mural_tpu_torch.ops._build`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mural_tpu_torch.device import constant
from mural_tpu_torch.genome.encode import ONE_HOT_TABLE
from mural_tpu_torch.ops._build import (I64, INT, PTR, KernelLibrary,
                                        check_launch, current_stream, launch)
from mural_tpu_torch.ops._plan import (MAX_SMEM, NUM_SMS, round_up,
                                       thread_runs)

SENTINEL = 15
NCODES = 16
# blocks a K1 call aims at when B is large: a few per SM
K1_TARGET_BLOCKS = 4 * NUM_SMS

# Launches of the CUDA kernel in this process (plain-version calls on CPU
# tensors do not count).  Callers reset it to 0 to count a run.
LAUNCHES = 0

LIBRARY = KernelLibrary("code_conv1d", {
    # codes, row stride, table, bias, out, B, L, k, C, then the plan:
    # rows, l_tile, positions, grid, threads, smem; stream
    "code_conv1d_launch": [PTR, I64, PTR, PTR, PTR, INT, INT, INT, INT, INT,
                           INT, INT, INT, INT, I64, PTR]})


def fold_bn_conv_table(conv_weight: torch.Tensor, conv_bias: torch.Tensor,
                       bn_weight: torch.Tensor, bn_bias: torch.Tensor,
                       bn_mean: torch.Tensor, bn_var: torch.Tensor,
                       eps: float = 1e-5):
    """Fold eval-mode BN + conv weights into a (k, 16, C) lookup table and
    a (C,) bias.  ``conv_weight`` is torch's (C, 4, k) layout."""
    a = bn_weight * torch.rsqrt(bn_var + eps)                # (4,)
    d = bn_bias - bn_mean * a                                # (4,)
    ohe = constant(ONE_HOT_TABLE, a.device, a.dtype)
    rows = torch.cat([ohe * a + d, torch.zeros_like(ohe[:1])])  # (16, 4)
    table = torch.einsum("nc,ock->kno", rows, conv_weight)
    return table.contiguous(), conv_bias


def code_conv1d_reference(codes: torch.Tensor, table: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: codes (B, L) uint8 -> (B, L, C) float32."""
    k = table.shape[0]
    p = (k - 1) // 2
    L = codes.shape[1]
    padded = torch.nn.functional.pad(codes.long(), (p, p), value=SENTINEL)
    acc = torch.zeros(codes.shape[0], L, table.shape[2],
                      dtype=torch.float32, device=codes.device)
    for kk in range(k):
        acc = acc + table[kk][padded[:, kk:kk + L]]
    return acc + bias.to(torch.float32)


def _k1_smem_bytes(k: int, C: int, R: int, TL: int) -> int:
    """Shared memory of one K1 block (the ``Layout`` of code_conv1d.cu):
    the (k, 16, C) table, the bias, and each of R rows' code span (TL
    positions and the k-1 halo) with room for a 16-byte cover."""
    return 4 * (k * NCODES * C + round_up(C, 4)) \
        + R * round_up(TL + k - 1 + 15, 16)


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """Launch plan of K1 on one call: block ``rb * n_ltiles + lt`` owns
    rows ``[rb*rows, (rb+1)*rows)`` and positions ``[lt*l_tile,
    (lt+1)*l_tile)``, both clipped to ``B`` and ``L``; a thread owns
    ``vec`` adjacent channels of a run of ``positions`` consecutive
    positions of one row."""
    B: int
    L: int
    rows: int
    l_tile: int
    n_ltiles: int
    grid: int
    vec: int
    threads: int
    positions: int
    smem: int

    def pieces(self):
        """``(b0, b1, l0, l1)`` of each block, in block order."""
        for i in range(self.grid):
            rb, lt = divmod(i, self.n_ltiles)
            yield (rb * self.rows, min(self.B, (rb + 1) * self.rows),
                   lt * self.l_tile, min(self.L, (lt + 1) * self.l_tile))


@functools.lru_cache(maxsize=256)
def k1_launch_plan(B: int, L: int, k: int, C: int) -> K1Plan:
    """How K1 cuts one call over the card: whole rows per block
    (``ceil(B / K1_TARGET_BLOCKS)``, fewer where shared memory runs out),
    and L-tiles when the rows alone give fewer blocks than SMs or one row
    does not fit.  The row stride does not enter: each row's codes come
    in as their own 16-byte cover, whatever its offset."""
    vec = 4 if C % 4 == 0 else 1
    if B <= 0 or L <= 0:
        return K1Plan(B, L, 1, 1, 1, 0, vec, 0, 1, 0)
    room = MAX_SMEM - _k1_smem_bytes(k, C, 0, 0)
    R = min(B, -(-B // K1_TARGET_BLOCKS))
    while R > 1 and _k1_smem_bytes(k, C, R, L) > MAX_SMEM:
        R -= 1
    n_rb = -(-B // R)
    TL = L if n_rb >= NUM_SMS else max(1, L // -(-NUM_SMS // n_rb))
    # the longest tile whose R code spans fit beside the table
    TL = min(TL, room // R // 16 * 16 - (k - 1) - 15)
    if TL < 1:
        raise ValueError(f"code_conv1d: k={k}, C={C} needs more shared "
                         f"memory than a block has")
    n_lt = -(-L // TL)
    TL = -(-L // n_lt)                 # balance the tiles of a row
    W, threads = thread_runs(R * (C // vec), TL)
    return K1Plan(B, L, R, TL, n_lt, n_rb * n_lt, vec, threads, W,
                  _k1_smem_bytes(k, C, R, TL))


def code_conv1d(codes: torch.Tensor, table: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Fused stem: codes (B, L) uint8 -> (B, L, C) float32 (the JAX
    package's channels-last layout).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  ``codes`` may be a row-strided view (tower 1's
    centre crop); table and bias must be contiguous."""
    if codes.device.type == "cpu":
        return code_conv1d_reference(codes, table, bias)
    if codes.device.type != "cuda":
        raise ValueError(f"code_conv1d: unsupported device {codes.device}")
    check_stem_args(codes, table, bias)
    B, L = codes.shape
    k, _, C = table.shape
    out = torch.empty((B, L, C), dtype=torch.float32, device=codes.device)
    plan = k1_launch_plan(B, L, k, C)
    if plan.grid == 0:
        return out
    lib = LIBRARY.load()
    err = launch(lib.code_conv1d_launch, codes.device,
                 codes.data_ptr(), codes.stride(0), table.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), B, L, k, C, plan.rows,
                 plan.l_tile, plan.positions, plan.grid, plan.threads,
                 plan.smem, current_stream(codes))
    check_launch(err, f"code_conv1d (B={B}, L={L}, k={k}, C={C})")
    global LAUNCHES
    LAUNCHES += 1
    return out


def check_stem_args(codes, table, bias, what: str = "code_conv1d"):
    """Raise on arguments the stem kernels (K1, K2, K3) do not take."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"{what}: codes must be a (B, L) uint8 tensor, "
                        f"got {codes.dtype} {tuple(codes.shape)}")
    if codes.shape[1] > 1 and codes.stride(1) != 1:
        raise ValueError(f"{what}: codes need unit column stride")
    if codes.shape[0] > 1 and codes.stride(0) < codes.shape[1]:
        raise ValueError(f"{what}: codes rows overlap")
    if table.dtype != torch.float32 or table.dim() != 3 \
            or table.shape[1] != NCODES or table.shape[0] % 2 != 1:
        raise TypeError(f"{what}: table must be a (k, 16, C) float32 "
                        "tensor with odd k, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (table.shape[2],):
        raise TypeError(f"{what}: bias must be a (C,) float32 tensor, "
                        f"got {bias.dtype} {tuple(bias.shape)}")
    if not (table.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"{what}: table and bias must be contiguous")
    if not (table.device == bias.device == codes.device):
        raise ValueError(f"{what}: codes, table and bias must be on "
                         "one device")
