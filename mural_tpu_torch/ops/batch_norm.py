"""Train-mode BatchNorm over ``(N, C, L)`` activations: kernel K5.

:class:`BatchNorm1d` is ``nn.BatchNorm1d`` with the same parameters,
buffers and state_dict keys.  In train mode a 3-D input goes through
:func:`batch_norm_train`: on a CUDA tensor the hand-written CUDA kernel
``csrc/batch_norm.cu`` (forward and backward, see the note there: it
replaces no Pallas kernel, why it was added, and its byte bound), on a
CPU tensor its plain PyTorch version, torch's own train-mode BatchNorm,
so that the CPU's numbers are torch's bit for bit.  Eval mode and 2-D
inputs run torch's own BatchNorm.

Both compute, for each channel over its ``M = N * L`` elements, the mean
and biased variance, ``y = (x - mean) * rsqrt(var + eps) * weight +
bias``, and torch's running-statistics update: ``(1 - momentum) * old +
momentum * stat`` with the unbiased variance ``var * M / (M - 1)``, and
``num_batches_tracked + 1``.  ``x`` may be float32 or bfloat16; the
statistics, parameters and their gradients stay float32 and ``y`` takes
``x``'s dtype.  The kernel is built with ``nvcc`` for ``sm_90a`` at
first use into ``build/kernels/`` (:mod:`mural_tpu_torch.ops._build`).
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from mural_tpu_torch.ops._build import (I64, INT, PTR, KernelLibrary,
                                        check_launch, count_launches,
                                        current_stream, launch)
from mural_tpu_torch.ops._plan import NUM_SMS

F32 = ctypes.c_float

# Launches of the CUDA kernels in this process: two a forward, two a
# backward (plain-version calls on CPU tensors do not count).  A launch
# that a CUDA graph records counts at each replay of the graph
# (``_build.py count_launches``), not at its capture.  Callers reset it
# to 0 to count a run.
LAUNCHES = 0
_THIS = sys.modules[__name__]


class _Args(ctypes.Structure):
    """``K5Args`` of ``csrc/batch_norm.cu``, the launchers' one argument:
    one call's tensors, shape, launch plan and scalars.  The forward fills
    it and keeps it for the backward, which adds its own tensors."""
    _fields_ = [(name, PTR) for name in (
        "x", "y", "dy", "dx", "stats", "weight", "bias", "running_mean",
        "running_var", "num_batches", "dweight", "dbias", "stream")] + [
        ("N", I64), ("L", I64), ("chunk", I64), ("C", INT),
        ("elem_bytes", INT), ("vec", INT), ("S", INT), ("eps", F32),
        ("momentum", F32)]


LIBRARY = KernelLibrary("batch_norm", {
    "k5_bn_forward": [ctypes.POINTER(_Args)],
    "k5_bn_backward": [ctypes.POINTER(_Args)]})

# blocks that fill the card (4 resident a SM at 256 threads), the least
# work worth a block of its own (vectors), and the most elements a block
# sums (its float32 counts stay exact)
TARGET_BLOCKS = 4 * NUM_SMS
MIN_BLOCK_VECTORS = 1024
MAX_BLOCK_ELEMENTS = 1 << 24


@functools.lru_cache(maxsize=None)
def bn_launch_plan(N: int, C: int, L: int, vec: int) -> Tuple[int, int]:
    """``(S, chunk)``: each channel's ``N * L / vec`` vectors cut into S
    chunks of ``chunk`` vectors, one block each, the last one possibly
    shorter and none empty: enough blocks over the C channels to fill
    the card where each still holds about ``MIN_BLOCK_VECTORS`` vectors
    or more, else blocks of about that size (one where the channel has
    fewer)."""
    Q = N * (L // vec)
    S = max(1, min(-(-TARGET_BLOCKS // C), -(-Q // MIN_BLOCK_VECTORS)),
            -(-Q * vec // MAX_BLOCK_ELEMENTS))
    chunk = -(-Q // S)
    return -(-Q // chunk), chunk


@functools.lru_cache(maxsize=None)
def _plan_args(N: int, C: int, L: int, elem_bytes: int, vec: int) -> _Args:
    """A call's shape and launch plan, which each call copies
    (``_Args.from_buffer_copy``) and fills in."""
    S, chunk = bn_launch_plan(N, C, L, vec)
    return _Args(N=N, L=L, chunk=chunk, C=C, elem_bytes=elem_bytes, vec=vec,
                 S=S)


def batch_norm_train_plain(x, weight, bias, running_mean, running_var,
                           num_batches_tracked, eps: float,
                           momentum: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`batch_norm_train`: torch's own
    train-mode BatchNorm, which computes the same formula, and the batch
    counter."""
    with torch.no_grad():
        num_batches_tracked.add_(1)
    return F.batch_norm(x, running_mean, running_var, weight, bias, True,
                        momentum, eps)


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     num_batches_tracked, eps: float,
                     momentum: float) -> torch.Tensor:
    """Train-mode BatchNorm of the ``(N, C, L)`` tensor ``x`` with float32
    ``weight``, ``bias`` and running statistics of ``C`` entries (updated
    in place, ``num_batches_tracked`` counting up); differentiable in
    ``x``, ``weight`` and ``bias``.

    A CPU tensor takes the plain version; a CUDA tensor launches K5 or
    raises."""
    if x.dim() != 3:
        raise ValueError(f"batch_norm_train: x must be (N, C, L), got "
                         f"{tuple(x.shape)}")
    N, C, L = x.shape
    if N * L <= 1:
        raise ValueError("Expected more than 1 value per channel when "
                         f"training, got input size {list(x.shape)}")
    if x.device.type == "cpu":
        return batch_norm_train_plain(x, weight, bias, running_mean,
                                      running_var, num_batches_tracked, eps,
                                      momentum)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_train: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"batch_norm_train: unsupported dtype {x.dtype} "
                        "(float32 or bfloat16)")
    _check_state(x.get_device(), C, weight, bias, running_mean, running_var,
                 num_batches_tracked)
    return _K5.apply(x, weight, bias, (running_mean, running_var,
                                       num_batches_tracked, float(eps),
                                       float(momentum)))


# (card, C, the state tensors' addresses and dtypes) of the states that
# passed :func:`_check_state`: a module's next calls skip its checks
_CHECKED = set()


def _check_state(card: int, C: int, weight, bias, running_mean, running_var,
                 num_batches_tracked) -> None:
    """Raise unless ``weight``, ``bias`` and the running statistics are
    contiguous float32 ``(C,)`` tensors and ``num_batches_tracked`` an
    int64 tensor, all on ``card``."""
    key = (card, C, weight.data_ptr(), bias.data_ptr(),
           running_mean.data_ptr(), running_var.data_ptr(),
           num_batches_tracked.data_ptr(), weight.dtype, bias.dtype,
           running_mean.dtype, running_var.dtype, num_batches_tracked.dtype)
    if key in _CHECKED:
        return
    for t in (weight, bias, running_mean, running_var):
        if (t.dtype != torch.float32 or t.dim() != 1 or t.shape[0] != C
                or t.get_device() != card or not t.is_contiguous()):
            raise TypeError("batch_norm_train: weight, bias and the running "
                            f"statistics must be contiguous float32 ({C},) "
                            f"tensors on cuda:{card}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    if num_batches_tracked.dtype != torch.int64 \
            or num_batches_tracked.get_device() != card:
        raise TypeError("batch_norm_train: num_batches_tracked must be an "
                        f"int64 tensor on cuda:{card}")
    if len(_CHECKED) >= 4096:
        _CHECKED.clear()
    _CHECKED.add(key)


def _vec(L: int, x) -> int:
    """4 elements a vector where the rows and ``x``'s start allow it,
    else 1."""
    return 4 if L % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0 \
        else 1


class _K5(torch.autograd.Function):
    """K5 forward and backward.  The running state travels as one
    argument; one :class:`_Args` per call carries the forward's launch
    plan, workspace and stream to the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, state):
        running_mean, running_var, num_batches_tracked, eps, momentum = state
        x = x.contiguous()
        N, C, L = x.shape
        esize = x.element_size()
        a = _Args.from_buffer_copy(_plan_args(N, C, L, esize, _vec(L, x)))
        y = torch.empty_like(x)          # aligned as every allocation
        # mean and rstd (kept for the backward), then the C x S partials
        stats = weight.new_empty(2 * C * (a.S + 1))
        a.x, a.y, a.stats = x.data_ptr(), y.data_ptr(), stats.data_ptr()
        a.weight, a.bias = weight.data_ptr(), bias.data_ptr()
        a.running_mean = running_mean.data_ptr()
        a.running_var = running_var.data_ptr()
        a.num_batches = num_batches_tracked.data_ptr()
        a.eps, a.momentum = eps, momentum
        a.stream = stream = current_stream(x)
        check_launch(launch(_launcher("k5_bn_forward"), x.device, a),
                     f"k5_bn_forward (N={N}, C={C}, L={L})")
        count_launches(_THIS, "LAUNCHES", 2, stream)
        ctx.save_for_backward(x, weight, stats)
        ctx.args = a
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, _ = ctx.saved_tensors
        a = ctx.args
        if dy.dtype != x.dtype:
            dy = dy.to(x.dtype)
        dy = dy.contiguous()
        if a.vec == 4 and _vec(a.L, dy) == 1:
            dy = dy.clone()              # a fresh allocation is aligned
        dx = torch.empty_like(x) if ctx.needs_input_grad[0] else None
        dweight, dbias = weight.new_empty(a.C), weight.new_empty(a.C)
        a.dy, a.dx = dy.data_ptr(), None if dx is None else dx.data_ptr()
        a.dweight, a.dbias = dweight.data_ptr(), dbias.data_ptr()
        # the forward's stream, which autograd runs the backward on
        check_launch(launch(_launcher("k5_bn_backward"), x.device, a),
                     f"k5_bn_backward (N={a.N}, C={a.C}, L={a.L})")
        count_launches(_THIS, "LAUNCHES", 2, a.stream)
        return dx, dweight, dbias, None


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    return getattr(LIBRARY.load(), name)


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose train-mode forward on an ``(N, C, L)``
    input is :func:`batch_norm_train` (K5 on a card).  Eval mode and
    ``(N, C)`` inputs run torch's BatchNorm.  The port's models build it
    with the affine parameters, running statistics and a momentum, as
    torch's defaults."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, device=None, dtype=None):
        if not (affine and track_running_stats and momentum is not None):
            raise ValueError("BatchNorm1d: the port's BatchNorm takes affine "
                             "parameters, running statistics and a momentum")
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and x.dim() == 3):
            return super().forward(x)
        if x.shape[1] != self.num_features:
            raise ValueError(f"BatchNorm1d({self.num_features}): input "
                             f"{tuple(x.shape)} has {x.shape[1]} channels")
        return batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                self.running_var, self.num_batches_tracked,
                                self.eps, self.momentum)
