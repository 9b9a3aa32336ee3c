"""ctypes bindings of the native host loops in ``encoder.cpp``
(counterpart of ``mural_tpu/native/__init__.py``).

The library is built with ``g++`` at first use into ``build/native/`` at
the root of the checkout, and rebuilt when it is older than its source.
There is no fallback: a failed build raises with the compiler's errors.
The numpy functions of :mod:`mural_tpu_torch.genome.encode`, the
prefix-sum means of :mod:`mural_tpu_torch.genome.tracks` and
:func:`format_pred_tsv_reference` are the plain versions these loops are
held against.  Processes that fan work out (the genome-wide output farm)
call :func:`load` before they spawn, so the workers find the library
built.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from mural_tpu_torch.genome import encode as enc
from mural_tpu_torch.genome.fasta import COMPLEMENT, N_CODE
from mural_tpu_torch.ops._build import build_shared

SOURCE = Path(__file__).resolve().parent / "encoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fno-math-errno",
             "-ffp-contract=off"]


class NativeLibrary:
    """``source`` compiled into ``so`` and loaded, once per process."""

    def __init__(self, source: Path, so: Path):
        self.source = source
        self.so = so
        self._lib = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._lib is not None:
                return self._lib
            if (not self.so.exists() or self.so.stat().st_mtime
                    < self.source.stat().st_mtime):
                build_shared(["g++", *GXX_FLAGS], self.source, self.so)
            lib = ctypes.CDLL(str(self.so))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            signatures = {
                "mural_gather_windows": ([u8p, i64, i64p, i64, i64, u8p,
                                          u8p, ctypes.c_uint8, u8p], None),
                "mural_kmer_pack": ([u8p, i64, i64, i64, i8p,
                                     ctypes.c_int32, i32p], None),
                "mural_track_mean": ([f64p, f32p, i64, i64, i64p, i64p,
                                      i64, f64p], None),
                "mural_format_pred_tsv": ([ctypes.c_char_p, i64, i64p, u8p,
                                           f64p, i64, i64, ctypes.c_char_p,
                                           i64], i64),
            }
            for name, (argtypes, restype) in signatures.items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = restype
            self._lib = lib
            return lib


LIBRARY = NativeLibrary(SOURCE, BUILD_DIR / "libmural_encoder.so")


def load():
    """The loaded library, built first if needed (raises if g++ fails)."""
    return LIBRARY.load()


def gather_windows(codes: np.ndarray, starts: np.ndarray, width: int,
                   neg_strand: np.ndarray) -> np.ndarray:
    """(N, width) uint8 code windows; the contract of
    :func:`mural_tpu_torch.genome.encode.gather_windows`."""
    if width < 0:
        raise ValueError(f"gather_windows: width {width} < 0")
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    neg = np.ascontiguousarray(neg_strand, dtype=np.uint8)
    if neg.shape != starts.shape:
        raise ValueError("gather_windows: starts and neg_strand differ in "
                         f"shape: {starts.shape} vs {neg.shape}")
    out = np.empty((len(starts), width), dtype=np.uint8)
    load().mural_gather_windows(codes, len(codes), starts, len(starts),
                                width, neg, COMPLEMENT, N_CODE, out)
    return out


def kmer_pack(windows: np.ndarray, k: int) -> np.ndarray:
    """Overlapping k-mer ids (N, W - k + 1) int32; the contract of
    :func:`mural_tpu_torch.genome.encode.kmer_ids`, which serves ``k``
    1 (digits, -1 for an ambiguous base)."""
    if k == 1:
        return enc.kmer_ids(windows, k)
    windows = np.ascontiguousarray(windows, dtype=np.uint8)
    n, w = windows.shape
    if not 1 < k <= w:
        raise ValueError(f"kmer_pack: k={k} for windows of width {w}")
    out = np.empty((n, w - k + 1), dtype=np.int32)
    load().mural_kmer_pack(windows, n, w, k, enc.DIGIT_TABLE, 4 ** k, out)
    return out


def track_mean(block_prefix: np.ndarray, inblock: np.ndarray,
               starts: np.ndarray, stops: np.ndarray,
               k: int) -> np.ndarray:
    """float64 means over [start, stop) of a two-level prefix-sum track
    (``block_prefix`` per ``k``-base block, float32 ``inblock`` sums),
    clipped to the track; 0 for an empty range."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    stops = np.ascontiguousarray(stops, dtype=np.int64)
    if starts.shape != stops.shape:
        raise ValueError("track_mean: starts and stops differ in shape")
    n = len(inblock)
    block_prefix = np.ascontiguousarray(block_prefix, dtype=np.float64)
    if len(block_prefix) != -(-n // k) + 1:
        raise ValueError(f"track_mean: {len(block_prefix)} block sums for "
                         f"{n} bases in blocks of {k}")
    out = np.empty(len(starts), dtype=np.float64)
    load().mural_track_mean(
        block_prefix, np.ascontiguousarray(inblock, dtype=np.float32), n,
        k, starts, stops, len(starts), out)
    return out


def format_pred_tsv(chrom: str, pos: np.ndarray, neg: np.ndarray,
                    probs: np.ndarray) -> bytes:
    """Prediction rows as TSV bytes: ``chrom start end strand mut_type
    prob0..N`` with ``end = start + 1``, ``mut_type`` the constant 0 (the
    genome-wide sites carry no observation) and probabilities ``%.4g``
    (the reference's ``to_csv`` float format)."""
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    neg = np.ascontiguousarray(neg, dtype=np.uint8)
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    n, n_class = probs.shape
    if len(pos) != n or len(neg) != n:
        raise ValueError(f"format_pred_tsv: {len(pos)} positions, "
                         f"{len(neg)} strands and {n} probability rows")
    if not n:
        return b""
    if pos.min() < 0:
        raise ValueError("format_pred_tsv: negative position")
    cb = chrom.encode()
    cap = n * (len(cb) + 2 * 21 + 2 + 2 + n_class * 14 + 8)
    buf = ctypes.create_string_buffer(cap)
    written = load().mural_format_pred_tsv(cb, len(cb), pos, neg, probs, n,
                                           n_class, buf, cap)
    if written < 0:
        raise RuntimeError("format_pred_tsv: row buffer overflow")
    return buf.raw[:written]


def format_pred_tsv_reference(chrom: str, pos: np.ndarray, neg: np.ndarray,
                              probs: np.ndarray) -> bytes:
    """Plain Python version of :func:`format_pred_tsv`."""
    return "".join(
        "\t".join([chrom, str(p), str(p + 1), "-" if ng else "+", "0"]
                  + ["%.4g" % v for v in row]) + "\n"
        for p, ng, row in zip(np.asarray(pos).tolist(),
                              np.asarray(neg).tolist(),
                              np.asarray(probs, np.float64).tolist())
    ).encode()
