"""The strand-resolved fractional one-hot of genome windows: kernel K4.

A distal window of ``width`` codes starting at ``starts[b]`` of the 1-D
uint8 code array ``src`` one-hots through the 16-row table
:data:`ONE_HOT16` (the 15 codes' fractional rows, then a zero row for
the sentinel code 15).  A window flagged in ``neg`` is on the minus
strand: its one-hot is the plus one flipped on both axes,
``one_hot(revcomp(c)) == one_hot(c)[::-1, ::-1]``.

:func:`window_one_hot` (the genome-wide map's encoder and resident
training's batches) and :func:`one_hot_from_codes` (a ``(N, L)`` code
tensor, read as ``N`` plus-strand windows at starts ``i * L``) run the
hand-written CUDA kernel ``csrc/window_one_hot.cu`` on CUDA tensors, in
one pass from the codes to the output (see the note there: it replaces
no Pallas kernel, why it was added, and its byte bound), and their plain
PyTorch versions on CPU tensors.  The two give the same bits: every
output element is a copy of a table element.  The kernel is built with
``nvcc`` for ``sm_90a`` at first use into ``build/kernels/``
(:mod:`mural_tpu_torch.ops._build`).
"""

from __future__ import annotations

import numpy as np
import torch

from mural_tpu_torch.device import constant
from mural_tpu_torch.genome.encode import ONE_HOT_TABLE
from mural_tpu_torch.ops._build import (I64, INT, PTR, KernelLibrary,
                                        check_launch, current_stream, launch)
from mural_tpu_torch.utils import spans

# 16 rows: the 15 codes plus a zero row for the sentinel code 15
ONE_HOT16 = np.concatenate([ONE_HOT_TABLE, np.zeros((1, 4), np.float32)])

# Launches of the CUDA kernel in this process (plain-version calls on
# CPU tensors do not count; a launch that a CUDA graph records counts
# once, at its capture).  Callers reset it to 0 to count a run.
LAUNCHES = 0

LIBRARY = KernelLibrary("window_one_hot", {
    # src, n_src, starts, row stride, neg, table, out, element bytes, B,
    # width; stream
    "window_one_hot_launch": [PTR, I64, PTR, I64, PTR, PTR, PTR, INT, I64,
                              INT, PTR]})


def one_hot_from_codes_plain(codes: torch.Tensor,
                             dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`one_hot_from_codes`."""
    return constant(ONE_HOT16, codes.device, dtype)[codes.long()]


def window_one_hot_plain(src: torch.Tensor, starts: torch.Tensor,
                         width: int, neg=None,
                         dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_one_hot`: the windows as
    rows of ``src.unfold(0, width, 1)``, their one-hot, and the minus
    rows flipped on both axes."""
    oh = one_hot_from_codes_plain(src.unfold(0, width, 1)[starts], dtype)
    if neg is None:
        return oh
    return torch.where(neg[:, None, None], oh.flip((1, 2)), oh)


def window_one_hot(src: torch.Tensor, starts: torch.Tensor, width: int,
                   neg=None, dtype=torch.float32) -> torch.Tensor:
    """``(B, width, 4)`` one-hot of the windows ``src[starts[b]:starts[b]
    + width]`` of the 1-D uint8 ``src``, flipped on both axes where the
    bool ``neg[b]`` is set (``neg=None``: every row on the plus strand).
    The windows must lie inside ``src``; ``starts`` are integers.

    A CPU tensor takes the plain version; a CUDA tensor launches K4 or
    raises."""
    if src.device.type == "cpu":
        return window_one_hot_plain(src, starts, width, neg, dtype)
    _check_cuda(src, "window_one_hot")
    if src.dtype != torch.uint8 or src.dim() != 1 or src.stride(0) != 1:
        raise TypeError("window_one_hot: src must be a 1-D contiguous uint8 "
                        f"tensor, got {src.dtype} {tuple(src.shape)}")
    if starts.dim() != 1 or (neg is not None and neg.shape != starts.shape):
        raise ValueError("window_one_hot: starts must be (B,) and neg "
                         f"(B,) or None, got {tuple(starts.shape)} and "
                         f"{None if neg is None else tuple(neg.shape)}")
    if not 0 <= width <= src.shape[0]:
        raise ValueError(f"window_one_hot: width {width} outside "
                         f"[0, {src.shape[0]}]")
    _check_dtype(dtype)
    starts = starts.to(src.device, torch.int64).contiguous()
    if neg is not None:
        neg = neg.to(src.device, torch.bool).contiguous()
    return _launch(src, src.shape[0], starts, 0, neg, starts.shape[0],
                   width, dtype)


def one_hot_from_codes(codes: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """uint8 genome codes (N, L) -> fractional one-hot (N, L, 4), on the
    device of ``codes``; code 15 one-hots to zeros.  Any leading shape
    goes: ``(..., L)`` -> ``(..., L, 4)``.

    A CPU tensor takes the plain version; a CUDA tensor launches K4 (the
    rows read as plus-strand windows, any row stride) or raises."""
    if codes.device.type == "cpu":
        return one_hot_from_codes_plain(codes, dtype)
    _check_cuda(codes, "one_hot_from_codes")
    if codes.dtype != torch.uint8 or codes.dim() == 0:
        raise TypeError("one_hot_from_codes: codes must be a uint8 tensor "
                        f"of at least one dimension, got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    _check_dtype(dtype)
    if codes.numel() == 0:
        return torch.empty((*codes.shape, 4), dtype=dtype,
                           device=codes.device)
    L = codes.shape[-1]
    rows = codes.reshape(-1, L)
    if L > 1 and rows.stride(1) != 1:
        rows = rows.contiguous()
    N = rows.shape[0]
    out = _launch(rows, (N - 1) * rows.stride(0) + L, None, rows.stride(0),
                  None, N, L, dtype)
    return out.view(*codes.shape, 4)


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_one_hot: unsupported dtype {dtype} "
                        "(float32 or bfloat16)")


def _launch(src, n_src, starts, row_stride, neg, B, width, dtype):
    """K4 on the ``n_src`` code bytes from ``src``'s first element;
    windows at ``starts`` or, where ``starts`` is None, at ``b *
    row_stride``."""
    out = torch.empty((B, width, 4), dtype=dtype, device=src.device)
    if B == 0 or width == 0:
        return out
    table = constant(ONE_HOT16, src.device, dtype)
    lib = LIBRARY.load()
    err = launch(lib.window_one_hot_launch, src.device, src.data_ptr(),
                 n_src, None if starts is None else starts.data_ptr(),
                 row_stride, None if neg is None else neg.data_ptr(),
                 table.data_ptr(), out.data_ptr(), out.element_size(), B,
                 width, current_stream(src))
    check_launch(err, f"window_one_hot (B={B}, width={width})")
    global LAUNCHES
    LAUNCHES += 1
    spans.count("feed.onehot_rows", B)
    return out
