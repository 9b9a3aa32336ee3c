"""The launch plan of the inference stem kernel K1
(``mural_tpu_torch.ops.fused_code_conv.k1_launch_plan``), checked on the
CPU: every (row, position) is covered exactly once, down to the threads'
runs, each block's staged code spans hold every tap its positions read,
shared memory fits one H100 block, and a call fills the card's SMs.  A
numpy walk of the kernel's blocks, covers and runs reproduces the plain
version exactly, tower 1's misaligned crop included."""
import numpy as np
import pytest
import torch

from mural_tpu_torch.ops._plan import (MAX_SMEM, MAX_THREADS, NUM_SMS,
                                       round_up)
from mural_tpu_torch.ops.fused_code_conv import (SENTINEL, _k1_smem_bytes,
                                                 code_conv1d_reference,
                                                 k1_launch_plan)


def _spans(plan, k, b0, b1, l0, l1):
    """What a block stages: each row's code span [l_lo, l_hi)."""
    p = (k - 1) // 2
    return max(0, l0 - p), min(plan.L, l1 + p)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("C", [8, 30, 32, 256])
@pytest.mark.parametrize("L", [201, 401, 2001], ids=["L201crop", "L401",
                                                     "L2001"])
@pytest.mark.parametrize("B", [1, 37, 256, 4096])
def test_k1_launch_plan(B, L, C, k):
    plan = k1_launch_plan(B, L, k, C)
    assert (plan.B, plan.L) == (B, L)
    assert plan.vec == (4 if C % 4 == 0 else 1)

    # every (row, position) in exactly one block
    hit = np.zeros((B, L), np.uint8)
    pieces = list(plan.pieces())
    assert len(pieces) == plan.grid
    for b0, b1, l0, l1 in pieces:
        assert 0 < b1 - b0 <= plan.rows and 0 < l1 - l0 <= plan.l_tile
        hit[b0:b1, l0:l1] += 1
    assert (hit == 1).all()
    if plan.n_ltiles == 1:             # whole rows
        assert plan.l_tile == L

    # shared memory fits one block and is the layout the kernel carves
    assert 0 < plan.smem <= MAX_SMEM
    assert plan.smem == _k1_smem_bytes(k, C, plan.rows, plan.l_tile)
    assert 0 < plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    # a call fills the card: at least one block per SM
    assert plan.grid >= NUM_SMS

    raw_stride = round_up(plan.l_tile + k - 1 + 15, 16)
    CG = C // plan.vec
    for b0, b1, l0, l1 in {pieces[0], pieces[-1]}:
        nl = l1 - l0
        # thread units (row, run, channel group): runs of `positions`
        # cover the piece's positions once
        nw = -(-nl // plan.positions)
        runs = [(w * plan.positions, min(nl, (w + 1) * plan.positions))
                for w in range(nw)]
        cover = np.zeros(nl, np.uint8)
        for a, b in runs:
            cover[a:b] += 1
        assert (cover == 1).all()
        assert (b1 - b0) * nw * CG > 0
        # every tap inside the row lies in the staged span, and the span
        # with any source offset (0..15) fits its row of shared memory
        l_lo, l_hi = _spans(plan, k, b0, b1, l0, l1)
        p = (k - 1) // 2
        taps = np.arange(l0 - p, l1 + p)
        inside = taps[(taps >= 0) & (taps < L)]
        assert inside.min() >= l_lo and inside.max() < l_hi
        assert round_up(15 + l_hi - l_lo, 16) <= raw_stride


def test_k1_launch_plan_empty_and_too_large():
    assert k1_launch_plan(0, 401, 3, 32).grid == 0
    assert k1_launch_plan(4, 0, 3, 32).grid == 0
    with pytest.raises(ValueError):
        k1_launch_plan(4, 401, 9, 512)          # the table alone: 295 KB


def test_k1_launch_plan_long_rows_take_tiles():
    """A row too long for one block's shared memory is cut into tiles."""
    plan = k1_launch_plan(4096, 300_001, 3, 32)
    assert plan.n_ltiles > 1 and plan.smem <= MAX_SMEM
    assert plan.l_tile * plan.n_ltiles >= 300_001


def _emulate_k1(flat, offset, row_stride, B, L, table, bias):
    """The kernel's blocks, staging and runs in numpy: ``flat`` holds the
    codes at byte ``offset + b*row_stride + l``, the address whose low 4
    bits the covers keep."""
    k, _, C = table.shape
    p = (k - 1) // 2
    plan = k1_launch_plan(B, L, k, C)
    raw_stride = round_up(plan.l_tile + k - 1 + 15, 16)
    V = plan.vec
    out = np.full((B, L, C), np.nan, np.float32)
    for b0, b1, l0, l1 in plan.pieces():
        nl = l1 - l0
        l_lo, l_hi = _spans(plan, k, b0, b1, l0, l1)
        raw = np.full((b1 - b0, raw_stride), 255, np.uint8)
        for r in range(b1 - b0):     # the 16-byte chunks that cover a span
            src = offset + (b0 + r) * row_stride + l_lo
            a0 = src & ~15
            for j in range(-(-(l_hi - l_lo + 30) // 16)):
                a = a0 + 16 * j
                if a < src + l_hi - l_lo:
                    raw[r, 16 * j:16 * j + 16] = flat[a:a + 16]
        nw = -(-nl // plan.positions)
        for r in range(b1 - b0):
            sh = (offset + (b0 + r) * row_stride + l_lo) & 15
            t_lo = l_lo - (l0 - p)

            def ext(t):
                ok = 0 <= t - t_lo < l_hi - l_lo
                return int(raw[r, sh - t_lo + t]) & 15 if ok else SENTINEL

            for w in range(nw):
                for lp in range(w * plan.positions,
                                min(nl, (w + 1) * plan.positions)):
                    for c in range(0, C, V):
                        acc = np.zeros(V, np.float32)
                        for kk in range(k):
                            acc = acc + table[kk, ext(lp + kk), c:c + V]
                        out[b0 + r, l0 + lp, c:c + V] = acc + bias[c:c + V]
    return out


@pytest.mark.parametrize("B,L,crop,C,k", [
    (3, 201, True, 8, 3),         # tower 1's crop: byte 100 of each row
    (37, 23, False, 30, 5),       # scalar channels, L-tiles
    (1, 61, True, 4, 7),
])
def test_k1_emulation_matches_plain(B, L, crop, C, k):
    rng = np.random.default_rng(B * 1000 + L)
    table = rng.normal(size=(k, 16, C)).astype(np.float32)
    table[:, SENTINEL] = 0.0
    bias = rng.normal(size=C).astype(np.float32)
    width = 2 * L - 1 if crop else L
    # a 16-byte aligned allocation with room for the covers' over-read
    flat = np.zeros(round_up(B * width + 32, 16), np.uint8)
    full = rng.integers(0, 15, size=(B, width), dtype=np.uint8)
    flat[:B * width] = full.reshape(-1)
    start = (L - 1) // 2 if crop else 0
    codes = full[:, start:start + L]
    got = _emulate_k1(flat, start, width, B, L, table, bias)
    ref = code_conv1d_reference(torch.from_numpy(np.ascontiguousarray(codes)),
                                torch.from_numpy(table),
                                torch.from_numpy(bias)).numpy()
    np.testing.assert_array_equal(got, ref)
