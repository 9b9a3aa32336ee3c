"""Fused one-hot + BatchNorm + Conv1d + MaxPool1d training stem of a
distal tower (counterpart of ``mural_tpu/ops/fused_train_stem.py``).

The conv input is a one-hot table row per position, and BatchNorm with
batch statistics is a per-channel affine whose statistics depend only on
the code histogram (:func:`hist_batch_stats`).  So the stem collapses to
the lookup table of :func:`mural_tpu_torch.ops.fused_code_conv.
fold_bn_conv_table`, followed by the pool:

    v[b, i, c]      = sum_kk T[kk, ext[b, i + kk], c] + bias[c]
    pooled[b, c, p] = max_j v[b, p*pk + j, c]  (first max: jstar[b, c, p])

on the pool-padded axis ``i`` (positions ``i < pp`` or ``i >= L + pp``
are pool padding and never win) with ``ext[b, t] = codes[b, t - pp -
cp]`` and the zero-row sentinel code 15 outside the row (the conv's zero
padding after the BN).  The statistics carry no parameter dependence, so
gradients reach the BN and conv parameters through the differentiable
table fold exactly as through the unfused composition.

:func:`code_conv_pool` runs the hand-written CUDA kernels of
``csrc/code_conv_pool.cu`` on CUDA tensors -- K2, the forward, and K3,
the backward, inside one ``torch.autograd.Function`` -- and the plain
PyTorch versions :func:`code_conv_pool_reference` and
:func:`code_conv_pool_backward_reference` on CPU tensors.  ``jstar`` is
``uint8`` (``jstar < pk <= 255``) in both.  The output is channels-first
``(B, C, P)``, the layout of the port's towers.

Two modes, the JAX op's ``split``: float32 (``bf16=False``, the table
exact, ``pooled`` and its gradient float32) and the single-pass mode of
``--bf16`` training (``bf16=True``, the JAX package's ``split=False``):
the table rounded once to bfloat16, the taps summed and the bias added
in float32, ``pooled`` stored as bfloat16 (the layer's cast), and the
gradient arriving in bfloat16.  ``table`` and ``bias`` are float32
inputs in both.  The launch counters count each mode apart.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import torch

from mural_tpu_torch.device import constant
from mural_tpu_torch.genome.encode import ONE_HOT_TABLE
from mural_tpu_torch.ops._build import (I64, INT, PTR, KernelLibrary,
                                        check_launch, count_launches,
                                        current_stream, launch)
from mural_tpu_torch.ops._plan import (MAX_SMEM, MAX_THREADS, NUM_SMS,
                                       round_up, thread_runs)
from mural_tpu_torch.ops.fused_code_conv import (NCODES, SENTINEL,
                                                 check_stem_args)

# Launches of each CUDA kernel in this process (plain-version calls on
# CPU tensors do not count).  Callers reset them to 0 to count a run.  A
# launch that a CUDA graph records counts at each replay of the graph
# (``_build.py count_launches``), not at its capture.
FWD_LAUNCHES = 0          # K2, float32 mode
BWD_LAUNCHES = 0          # K3 (with its partial-sum reduce), float32 mode
FWD_BF16_LAUNCHES = 0     # K2, bf16 mode
BWD_BF16_LAUNCHES = 0     # K3, bf16 mode
_COUNTERS = ("FWD_LAUNCHES", "BWD_LAUNCHES", "FWD_BF16_LAUNCHES",
             "BWD_BF16_LAUNCHES")
_THIS = sys.modules[__name__]

LIBRARY = KernelLibrary("code_conv_pool", {
    # codes, row stride, table, bias, pooled, jstar, B, L, k, C, pk, pp,
    # P, then the plan: rows, p_tile, windows, grid, threads, smem; the
    # mode (1: bf16); stream
    "code_conv_pool_fwd_launch": [PTR, I64, PTR, PTR, PTR, PTR, INT, INT,
                                  INT, INT, INT, INT, INT, INT, INT, INT,
                                  INT, INT, I64, INT, PTR],
    # codes, row stride, jstar, g, partial, dtable, B, L, k, C, pk, pp, P,
    # then the plan: rows, p_tile, groups, threads, grid, smem; the mode;
    # stream
    "code_conv_pool_bwd_launch": [PTR, I64, PTR, PTR, PTR, PTR, INT, INT,
                                  INT, INT, INT, INT, INT, INT, INT, INT,
                                  INT, INT, I64, INT, PTR],
})
# pieces (blocks of K2) a call aims at when B is large: a few per SM
TARGET_BLOCKS = 4 * NUM_SMS
# K3 blocks per SM: each walks several pieces into its slabs, so a call
# writes at most this many partials per SM for the reduce
BWD_BLOCKS_PER_SM = 2


def pool_out_len(L: int, pk: int, pp: int) -> int:
    """torch MaxPool1d floor output length (stride == kernel)."""
    return (L + 2 * pp - pk) // pk + 1


def hist_batch_stats(codes: torch.Tensor, reduce=None):
    """BatchNorm batch statistics of ``one_hot(codes)`` from the 15-code
    histogram: ``(mean (4,), biased var (4,), unbiased var (4,))`` float32.

    The counts come from ``scatter_add_`` rather than ``torch.bincount``,
    which synchronises with the host on CUDA tensors; the contraction
    with the one-hot table runs in float64, then rounds once.  With
    ``reduce`` (a data-parallel step: the SUM over the ranks, in place)
    the 16 int64 counts, whose sum is the element count, are reduced
    first, so the statistics are the global batch's."""
    n = codes.numel()
    idx = codes.reshape(-1).long() & 15
    cnt = torch.zeros(NCODES, dtype=torch.int64, device=codes.device)
    cnt.scatter_add_(0, idx, torch.ones_like(idx))
    if reduce is not None:
        cnt = reduce(cnt)
        n = cnt.sum().double()          # a device scalar: no host sync
    t = constant(ONE_HOT_TABLE, codes.device, torch.float64)   # (15, 4)
    cnt = cnt[:15].double()
    mean = (cnt @ t) / n
    var = torch.clamp((cnt @ (t * t)) / n - mean * mean, min=0.0)
    if reduce is not None:
        unbiased = var * (n / torch.clamp(n - 1, min=1))
    else:
        unbiased = var * (n / max(n - 1, 1))
    return mean.float(), var.float(), unbiased.float()


def _ext_codes(codes: torch.Tensor, k: int, pp: int, P: int, pk: int):
    """(B, L) codes -> (B, P*pk + k - 1) int64 ``ext`` (sentinel padded)."""
    L = codes.shape[1]
    lo = pp + (k - 1) // 2
    hi = max(P * pk + k - 1 - lo - L, 0)
    ext = torch.nn.functional.pad(codes.long(), (lo, hi), value=SENTINEL)
    return ext[:, :P * pk + k - 1]


def code_conv_pool_reference(codes: torch.Tensor, table: torch.Tensor,
                             bias: torch.Tensor, pk: int, pp: int,
                             bf16: bool = False):
    """Plain PyTorch version of K2: ``(pooled (B, C, P) float32, jstar
    (B, C, P) uint8)``, after ``_reference_fwd`` of the JAX package.
    ``bf16``: the table rounded to bfloat16 first, and pooled returned
    as bfloat16."""
    if bf16:
        table = table.to(torch.bfloat16).float()
    k, _, C = table.shape
    B, L = codes.shape
    P = pool_out_len(L, pk, pp)
    Lp = P * pk
    ext = _ext_codes(codes, k, pp, P, pk)
    acc = torch.zeros(B, Lp, C, dtype=torch.float32, device=codes.device)
    for kk in range(k):
        acc = acc + table[kk][ext[:, kk:kk + Lp]]
    acc = acc + bias.to(torch.float32)
    i = torch.arange(Lp, device=codes.device)[None, :, None]
    acc = torch.where((i >= pp) & (i < L + pp), acc, float("-inf"))
    xw = acc.reshape(B, P, pk, C)
    best = xw[:, :, 0]
    best_j = torch.zeros(B, P, C, dtype=torch.uint8, device=codes.device)
    for j in range(1, pk):
        upd = xw[:, :, j] > best                 # first max wins ties
        best = torch.where(upd, xw[:, :, j], best)
        best_j = torch.where(upd, j, best_j)
    best = best.to(torch.bfloat16) if bf16 else best
    return (best.permute(0, 2, 1).contiguous(),
            best_j.permute(0, 2, 1).contiguous())


def code_conv_pool_backward_reference(codes: torch.Tensor,
                                      jstar: torch.Tensor, g: torch.Tensor,
                                      k: int, pk: int, pp: int,
                                      bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3: ``dtable (k, 16, C)`` float32 from
    ``g (B, C, P)`` routed to the first-max positions ``jstar``, after
    ``_reference_bwd`` of the JAX package.  ``bf16``: ``g`` rounded to
    bfloat16 first (the gradient of the bf16 mode's output)."""
    if bf16:
        g = g.to(torch.bfloat16)
    B, C, P = g.shape
    ext = _ext_codes(codes, k, pp, P, pk)
    pos = (torch.arange(P, device=g.device) * pk)[None, None, :] \
        + jstar.long()                                      # (B, C, P)
    chan = torch.arange(C, device=g.device)[None, :, None]
    g = g.to(torch.float32)
    dtable = torch.zeros(k, NCODES * C, dtype=torch.float32,
                         device=g.device)
    for kk in range(k):
        q = ext.gather(1, (pos + kk).reshape(B, C * P)).reshape(B, C, P)
        dtable[kk].index_add_(0, (q * C + chan).reshape(-1), g.reshape(-1))
    return dtable.reshape(k, NCODES, C)


def _check_pool(pk: int, pp: int):
    if not (0 < pk <= 255 and 0 <= 2 * pp <= pk):
        raise ValueError(f"code_conv_pool: need 0 < pk <= 255 and "
                         f"0 <= pp <= pk/2, got pk={pk}, pp={pp}")


def _smem_bytes(k, C, R, TP, pk, groups, backward, elem=4) -> int:
    """Shared memory of one block (the ``Layout`` of code_conv_pool.cu).
    K2: table and bias, the (R, C, TP) pooled and uint8 output tiles
    (each with room to shift by its misalignment); K3: the slabs and the
    g and jstar tiles as R*C segments with room for a 16-byte cover; both:
    each row's raw code span and its ext codes.  ``elem``: the bytes of a
    pooled or g element (4, or 2 in the bf16 mode)."""
    n, n_ext = R * C * TP, TP * pk + k - 1
    slab = k * NCODES * C
    per = 16 // elem
    if backward:
        head = 4 * groups * slab + R * C * (round_up(elem * TP + 15, 16)
                                            + round_up(TP + 15, 16))
    else:
        head = (4 * (slab + round_up(C, 4)) + elem * round_up(n + per, per)
                + round_up(n + 16, 16))
    return head + R * (round_up(n_ext + 15, 16) + n_ext)


@dataclasses.dataclass(frozen=True)
class StemPlan:
    """Launch plan of K2 (forward) or K3 (backward) on one stem call.

    Piece ``rb * n_ptiles + pt`` is rows ``[rb*rows, (rb+1)*rows)`` and
    pool windows ``[pt*p_tile, (pt+1)*p_tile)``, both clipped to ``B`` and
    ``P``.  K2 runs one block per piece, and a thread owns ``vec``
    adjacent channels of a run of ``windows`` windows of one row.  K3 runs
    ``grid`` blocks, block ``i`` walking pieces ``i, i + grid, ...``, with
    ``groups`` slabs of ``threads // groups`` threads each; a group walks
    a fixed run of each piece's (row, window) pairs."""
    B: int
    P: int
    rows: int
    p_tile: int
    n_ptiles: int
    n_pieces: int
    grid: int
    vec: int
    threads: int
    windows: int
    groups: int
    smem: int

    def pieces(self):
        """``(b0, b1, p0, p1)`` of each piece, in piece order."""
        for i in range(self.n_pieces):
            rb, pt = divmod(i, self.n_ptiles)
            yield (rb * self.rows, min(self.B, (rb + 1) * self.rows),
                   pt * self.p_tile, min(self.P, (pt + 1) * self.p_tile))


@functools.lru_cache(maxsize=256)
def stem_launch_plan(B: int, L: int, k: int, C: int, pk: int, pp: int,
                     backward: bool = False, elem: int = 4) -> StemPlan:
    """How K2 or K3 cuts one call over the card: whole rows per piece
    (``ceil(B / TARGET_BLOCKS)``, fewer where shared memory runs out),
    and P-tiles when the rows alone give fewer pieces than SMs or one row
    does not fit.  ``elem``: the bytes of a pooled or g element (2 in the
    bf16 mode)."""
    _check_pool(pk, pp)
    P = max(pool_out_len(L, pk, pp), 0)
    vec = 4 if C % 4 == 0 else 1
    lanes = min(C, MAX_THREADS)          # K3 threads of one slab group

    def bwd_shape(R, TP):
        """K3's (grid, groups) for pieces of R rows and TP windows: as
        many slab groups as fit the block's threads, at most one per
        (row, window) pair a block walks."""
        n = -(-B // R) * -(-P // TP)
        grid = min(n, BWD_BLOCKS_PER_SM * NUM_SMS)
        return grid, min(MAX_THREADS // lanes, -(-n // grid) * R * TP)

    def smem(R, TP):
        groups = bwd_shape(R, TP)[1] if backward else 0
        return _smem_bytes(k, C, R, TP, pk, groups, backward, elem)

    if B <= 0 or P == 0:
        return StemPlan(B, P, 1, 1, 1, 0, 0, vec, 0, 1, 1, 0)
    R = min(B, -(-B // TARGET_BLOCKS))
    while R > 1 and smem(R, P) > MAX_SMEM:
        R -= 1
    n_rb = -(-B // R)
    n_pt = 1 if n_rb >= NUM_SMS else min(P, -(-NUM_SMS // n_rb))
    while n_pt < P and smem(R, -(-P // n_pt)) > MAX_SMEM:
        n_pt += 1
    TP = -(-P // n_pt)
    n_pt = -(-P // TP)
    if smem(R, TP) > MAX_SMEM:
        raise ValueError(f"code_conv_pool: k={k}, C={C} needs more shared "
                         f"memory than a block has ({smem(R, TP)} bytes)")
    if backward:
        grid, G = bwd_shape(R, TP)
        threads, W = G * lanes, 0
    else:
        grid, G = n_rb * n_pt, 0
        W, threads = thread_runs(R * (C // vec), TP)
    return StemPlan(B, P, R, TP, n_pt, n_rb * n_pt, grid, vec, threads, W,
                    G, smem(R, TP))


def _dtype(bf16: bool):
    return torch.bfloat16 if bf16 else torch.float32


def _fwd_kernel(codes, table, bias, pk, pp, bf16):
    check_stem_args(codes, table, bias, "code_conv_pool")
    B, L = codes.shape
    k, _, C = table.shape
    P = pool_out_len(L, pk, pp)
    pooled = torch.empty((B, C, P), dtype=_dtype(bf16), device=codes.device)
    jstar = torch.empty((B, C, P), dtype=torch.uint8, device=codes.device)
    plan = stem_launch_plan(B, L, k, C, pk, pp, elem=pooled.element_size())
    if plan.grid == 0:
        return pooled, jstar
    lib = LIBRARY.load()
    stream = current_stream(codes)
    err = launch(lib.code_conv_pool_fwd_launch, codes.device,
                 codes.data_ptr(), codes.stride(0), table.data_ptr(),
                 bias.data_ptr(), pooled.data_ptr(), jstar.data_ptr(), B, L,
                 k, C, pk, pp, P, plan.rows, plan.p_tile, plan.windows,
                 plan.grid, plan.threads, plan.smem, int(bf16), stream)
    check_launch(err, f"code_conv_pool forward (B={B}, L={L}, k={k}, "
                      f"C={C}, pk={pk}, bf16={bf16})")
    count_launches(_THIS, _COUNTERS[2 * bf16], 1, stream)
    return pooled, jstar


def _bwd_kernel(codes, jstar, g, k, pk, pp, bf16):
    B, C, P = g.shape
    L = codes.shape[1]
    if not (g.dtype == _dtype(bf16) and g.is_contiguous()
            and jstar.dtype == torch.uint8 and jstar.is_contiguous()
            and tuple(jstar.shape) == (B, C, P)
            and codes.dtype == torch.uint8 and codes.dim() == 2
            and codes.shape[0] == B and codes.stride(1) == 1
            and P == pool_out_len(L, pk, pp)
            and g.device == codes.device == jstar.device):
        raise TypeError("code_conv_pool backward: need (B, L) uint8 codes "
                        "with unit column stride, and contiguous g (float32,"
                        " or bfloat16 in the bf16 mode) and uint8 jstar of "
                        "one (B, C, P) shape, P the pool's output length, "
                        "all on one device")
    plan = stem_launch_plan(B, L, k, C, pk, pp, backward=True,
                            elem=g.element_size())
    if plan.grid == 0:
        return torch.zeros((k, NCODES, C), dtype=torch.float32,
                           device=g.device)
    partial = torch.empty((plan.grid, k * NCODES * C), dtype=torch.float32,
                          device=g.device)
    dtable = torch.empty((k, NCODES, C), dtype=torch.float32, device=g.device)
    lib = LIBRARY.load()
    stream = current_stream(g)
    err = launch(lib.code_conv_pool_bwd_launch, g.device,
                 codes.data_ptr(), codes.stride(0), jstar.data_ptr(),
                 g.data_ptr(), partial.data_ptr(), dtable.data_ptr(), B, L,
                 k, C, pk, pp, P, plan.rows, plan.p_tile, plan.groups,
                 plan.threads, plan.grid, plan.smem, int(bf16), stream)
    check_launch(err, f"code_conv_pool backward (B={B}, L={L}, k={k}, "
                      f"C={C}, pk={pk}, bf16={bf16})")
    count_launches(_THIS, _COUNTERS[2 * bf16 + 1], 1, stream)
    return dtable


def reset_launches() -> None:
    """Set every launch counter to 0."""
    for counter in _COUNTERS:
        setattr(_THIS, counter, 0)


def launch_counts() -> dict:
    """The counters by kernel and mode."""
    return {"k2": FWD_LAUNCHES, "k3": BWD_LAUNCHES,
            "k2_bf16": FWD_BF16_LAUNCHES, "k3_bf16": BWD_BF16_LAUNCHES}


def code_conv_pool_forward(codes, table, bias, pk: int, pp: int,
                           bf16: bool = False):
    """``(pooled, jstar)``: K2 on a CUDA tensor, the plain version on a
    CPU tensor; any other device raises."""
    _check_pool(pk, pp)
    if codes.device.type == "cpu":
        return code_conv_pool_reference(codes, table, bias, pk, pp, bf16)
    if codes.device.type != "cuda":
        raise ValueError(f"code_conv_pool: unsupported device {codes.device}")
    return _fwd_kernel(codes, table, bias, pk, pp, bf16)


def code_conv_pool_backward(codes, jstar, g, k: int, pk: int, pp: int,
                            bf16: bool = False):
    """``dtable``: K3 on a CUDA tensor, the plain version on a CPU
    tensor."""
    if g.device.type == "cpu":
        return code_conv_pool_backward_reference(codes, jstar, g, k, pk, pp,
                                                 bf16)
    if g.device.type != "cuda":
        raise ValueError(f"code_conv_pool: unsupported device {g.device}")
    return _bwd_kernel(codes, jstar, g, k, pk, pp, bf16)


class CodeConvPool(torch.autograd.Function):
    """K2 forward, K3 backward; ``dbias = g.sum`` stays a torch
    reduction (in float32), as the JAX package computes it outside its
    kernel."""

    @staticmethod
    def forward(ctx, codes, table, bias, pk: int, pp: int, bf16: bool):
        pooled, jstar = code_conv_pool_forward(codes, table, bias, pk, pp,
                                               bf16)
        ctx.save_for_backward(codes, jstar)
        ctx.k, ctx.pk, ctx.pp, ctx.bf16 = table.shape[0], pk, pp, bf16
        return pooled

    @staticmethod
    def backward(ctx, g):
        codes, jstar = ctx.saved_tensors
        g = g.to(_dtype(ctx.bf16)).contiguous()
        dtable = dbias = None
        if ctx.needs_input_grad[1]:
            dtable = code_conv_pool_backward(codes, jstar, g, ctx.k, ctx.pk,
                                             ctx.pp, ctx.bf16)
        if ctx.needs_input_grad[2]:
            dbias = g.float().sum((0, 2))
        return None, dtable, dbias, None, None, None


def code_conv_pool(codes: torch.Tensor, table: torch.Tensor,
                   bias: torch.Tensor, pk: int, pp: int,
                   bf16: bool = False) -> torch.Tensor:
    """codes (B, L) uint8 (row-strided views allowed), table (k, 16, C)
    and bias (C,) float32 -> pooled (B, C, P), float32, or bfloat16 in
    the single-pass mode (``bf16``); differentiable in ``table`` and
    ``bias``.  ``pk``/``pp`` are the pool kernel (== stride) and padding;
    the table's sentinel row 15 must be zero."""
    return CodeConvPool.apply(codes, table, bias, pk, pp, bf16)
