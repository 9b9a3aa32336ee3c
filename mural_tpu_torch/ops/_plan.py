"""What the launch plans of the stem kernels share: the card they fill
(K1's ``k1_launch_plan`` in :mod:`fused_code_conv`, K2/K3's
``stem_launch_plan`` in :mod:`fused_train_stem`) and the cut of a
block's work into threads' runs.  ``csrc/stem.cuh`` repeats the
per-block limits for the launchers' checks."""

from __future__ import annotations

from typing import Tuple

# An H100's SMs, and the shared memory and threads one block may use
NUM_SMS = 132
MAX_SMEM = 232_448
MAX_THREADS = 256


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def thread_runs(slots: int, n: int) -> Tuple[int, int]:
    """``(W, threads)`` of a block in which each of ``slots`` (row,
    channel group) pairs walks ``n`` consecutive positions in runs of
    ``W``: as many runs per pair as the block's threads allow, and the
    threads that those runs need, in whole warps.  A block with more
    slots than threads loops over them."""
    nw = max(1, min(n, MAX_THREADS // slots))
    W = -(-n // nw)
    return W, min(MAX_THREADS, round_up(slots * -(-n // W), 32))
