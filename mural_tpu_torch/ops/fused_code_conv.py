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
bounds it and how it is laid out) and the plain PyTorch version
:func:`code_conv1d_reference` on CPU tensors.  The kernel is built with
``nvcc`` for ``sm_90a`` at first use into ``build/kernels/`` at the root
of the checkout and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from mural_tpu_torch.genome.encode import ONE_HOT_TABLE

SENTINEL = 15
NCODES = 16
MAX_TILE_L = 256

# Launches of the CUDA kernel in this process (plain-version calls on CPU
# tensors do not count).  Callers reset it to 0 to count a run.
LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "code_conv1d.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""


def fold_bn_conv_table(conv_weight: torch.Tensor, conv_bias: torch.Tensor,
                       bn_weight: torch.Tensor, bn_bias: torch.Tensor,
                       bn_mean: torch.Tensor, bn_var: torch.Tensor,
                       eps: float = 1e-5):
    """Fold eval-mode BN + conv weights into a (k, 16, C) lookup table and
    a (C,) bias.  ``conv_weight`` is torch's (C, 4, k) layout."""
    a = bn_weight * torch.rsqrt(bn_var + eps)                # (4,)
    d = bn_bias - bn_mean * a                                # (4,)
    ohe = torch.as_tensor(ONE_HOT_TABLE, dtype=a.dtype, device=a.device)
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
    _check_args(codes, table, bias)
    B, L = codes.shape
    k, _, C = table.shape
    out = torch.empty((B, L, C), dtype=torch.float32, device=codes.device)
    # balance the L-tiles of a row: L=401 -> 2 tiles of 201
    tile_l = -(-L // -(-L // MAX_TILE_L)) if L else 1
    lib = load_library()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.code_conv1d_launch(
            codes.data_ptr(), codes.stride(0), table.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, L, k, C, tile_l, stream)
    if err != 0:
        raise RuntimeError(f"code_conv1d kernel launch failed: CUDA error "
                           f"{err} (B={B}, L={L}, k={k}, C={C})")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _check_args(codes, table, bias):
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError("code_conv1d: codes must be a (B, L) uint8 tensor, "
                        f"got {codes.dtype} {tuple(codes.shape)}")
    if codes.shape[1] > 1 and codes.stride(1) != 1:
        raise ValueError("code_conv1d: codes need unit column stride")
    if codes.shape[0] > 1 and codes.stride(0) < codes.shape[1]:
        raise ValueError("code_conv1d: codes rows overlap")
    if table.dtype != torch.float32 or table.dim() != 3 \
            or table.shape[1] != NCODES or table.shape[0] % 2 != 1:
        raise TypeError("code_conv1d: table must be a (k, 16, C) float32 "
                        "tensor with odd k, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (table.shape[2],):
        raise TypeError("code_conv1d: bias must be a (C,) float32 tensor, "
                        f"got {bias.dtype} {tuple(bias.shape)}")
    if not (table.is_contiguous() and bias.is_contiguous()):
        raise ValueError("code_conv1d: table and bias must be contiguous")
    if not (table.device == bias.device == codes.device):
        raise ValueError("code_conv1d: codes, table and bias must be on "
                         "one device")


def load_library():
    """Build (when the .so is missing or older than the source) and load
    the kernel library."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = BUILD_DIR / "libcode_conv1d.so"
        if not so.exists() or so.stat().st_mtime < SOURCE.stat().st_mtime:
            BUILD_LOG = build(so)
        lib = ctypes.CDLL(str(so))
        lib.code_conv1d_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.code_conv1d_launch.restype = ctypes.c_int
        _lib = lib
        return _lib


def build(so: Path) -> str:
    """Compile ``SOURCE`` into ``so`` with nvcc; returns the compiler's
    output (register and shared-memory use from ``-Xptxas -v``)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("code_conv1d: nvcc not found (needed to build "
                           f"{SOURCE.name} for CUDA tensors)")
    so.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename, so concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return res.stdout + res.stderr
