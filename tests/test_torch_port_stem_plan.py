"""The launch plan of the fused training stem's kernels K2 and K3
(``mural_tpu_torch.ops.fused_train_stem.stem_launch_plan``), checked on
the CPU: every (row, pool window) pair is covered exactly once, down to
the threads' runs, shared memory fits one H100 block, and the training
batch (B=128) fills the card's SMs."""
import numpy as np
import pytest

from mural_tpu_torch.ops.fused_train_stem import (MAX_SMEM, MAX_THREADS,
                                                  NUM_SMS, _smem_bytes,
                                                  pool_out_len,
                                                  stem_launch_plan)

K = 3
POOLS = [(15, 7), (3, 1)]          # tower 2's and tower 1's pools


def _runs(n: int, size: int):
    """[start, end) runs of ``size`` over ``range(n)`` as the kernels cut
    them: run i is [i*size, min(n, (i+1)*size)) for i < ceil(n/size)."""
    return [(i * size, min(n, (i + 1) * size)) for i in range(-(-n // size))]


def _check_runs(runs, n):
    hit = np.zeros(n, int)
    for a, b in runs:
        hit[a:b] += 1
    assert (hit == 1).all()


@pytest.mark.parametrize("backward", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("pk,pp", POOLS)
@pytest.mark.parametrize("L", [201, 401, 2001])
@pytest.mark.parametrize("C", [8, 30, 32, 256])
@pytest.mark.parametrize("B", [1, 37, 128, 2048, 4096])
def test_stem_launch_plan(B, C, L, pk, pp, backward):
    plan = stem_launch_plan(B, L, K, C, pk, pp, backward)
    P = pool_out_len(L, pk, pp)
    assert (plan.B, plan.P) == (B, P)
    assert plan.vec == (4 if C % 4 == 0 else 1)

    # every (row, window) pair in exactly one piece
    hit = np.zeros((B, P), np.int32)
    pieces = list(plan.pieces())
    assert len(pieces) == plan.n_pieces
    for b0, b1, p0, p1 in pieces:
        assert b1 - b0 <= plan.rows and p1 - p0 <= plan.p_tile
        hit[b0:b1, p0:p1] += 1
    assert (hit == 1).all()
    if plan.n_ptiles == 1:             # whole rows: one contiguous run
        assert plan.p_tile == P

    # shared memory fits one block, and is the layout the kernels carve
    assert 0 < plan.smem <= MAX_SMEM
    assert plan.smem == _smem_bytes(K, C, plan.rows, plan.p_tile, pk,
                                    plan.groups, backward)
    assert 0 < plan.threads <= MAX_THREADS

    if not backward:
        # one block per piece; thread units (row, run of windows, channel
        # group) cover each piece's (row, window, channel) once
        assert plan.grid == plan.n_pieces
        assert plan.threads % 32 == 0
        for b0, b1, p0, p1 in {(0, plan.rows, 0, plan.p_tile), pieces[-1]}:
            _check_runs(_runs(p1 - p0, plan.windows), p1 - p0)
        assert C % plan.vec == 0
    else:
        # blocks walk pieces i, i + grid, ...: each piece once
        assert 1 <= plan.grid <= plan.n_pieces
        walked = sorted(i for blk in range(plan.grid)
                        for i in range(blk, plan.n_pieces, plan.grid))
        assert walked == list(range(plan.n_pieces))
        # groups split a piece's pairs into fixed runs; each group's
        # threads cover the channels
        lanes = plan.threads // plan.groups
        assert plan.threads == plan.groups * min(C, MAX_THREADS)
        assert set(range(C)) == {c for t in range(lanes)
                                 for c in range(t, C, lanes)}
        for b0, b1, p0, p1 in {pieces[0], pieces[-1]}:
            n_pairs = (b1 - b0) * (p1 - p0)
            per = -(-n_pairs // plan.groups)
            runs = [(min(n_pairs, g * per), min(n_pairs, g * per + per))
                    for g in range(plan.groups)]
            _check_runs(runs, n_pairs)

    if B == 128:                       # the training batch fills the card
        assert plan.grid >= NUM_SMS


def test_stem_launch_plan_empty_and_bad_pool():
    assert stem_launch_plan(0, 401, K, 32, 15, 7).grid == 0
    assert stem_launch_plan(4, 0, K, 32, 3, 0, True).grid == 0
    with pytest.raises(ValueError):
        stem_launch_plan(4, 401, K, 32, 15, 8)
