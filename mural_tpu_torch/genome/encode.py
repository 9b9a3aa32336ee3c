"""Vectorised sequence encodings from uint8 genome codes (counterpart of
``mural_tpu/genome/encode.py``)."""

from __future__ import annotations

import numpy as np

from mural_tpu_torch.genome.fasta import COMPLEMENT, N_CODE, NUM_CODES

# Fractional one-hot rows per IUPAC code (A, C, G, T axes).
ONE_HOT_TABLE = np.array(
    [
        [1, 0, 0, 0],          # A
        [0, 1, 0, 0],          # C
        [0, 0, 1, 0],          # G
        [0, 0, 0, 1],          # T
        [0.5, 0, 0.5, 0],      # R = A/G
        [0, 0.5, 0, 0.5],      # Y = C/T
        [0.5, 0.5, 0, 0],      # M = A/C
        [0, 0.5, 0.5, 0],      # S = C/G
        [0.5, 0, 0, 0.5],      # W = A/T
        [0, 0, 0.5, 0.5],      # K = G/T
        [0, 1 / 3, 1 / 3, 1 / 3],  # B = not A
        [1 / 3, 0, 1 / 3, 1 / 3],  # D = not C
        [1 / 3, 1 / 3, 0, 1 / 3],  # H = not G
        [1 / 3, 1 / 3, 1 / 3, 0],  # V = not T
        [0.25, 0.25, 0.25, 0.25],  # N
    ],
    dtype=np.float32,
)
assert ONE_HOT_TABLE.shape == (NUM_CODES, 4)

# code -> digit (A/C/G/T -> 0..3, ambiguity codes -> -1)
DIGIT_TABLE = np.concatenate(
    [np.arange(4, dtype=np.int8), np.full(NUM_CODES - 4, -1, dtype=np.int8)])


def expanded_start(start: np.ndarray, radius: int,
                   model_type: str = "snv") -> np.ndarray:
    """Left edge of the radius-expanded window around a BED interval
    (SNV: [start - r, start + r + 1); INDEL: [start - r + 1, stop + r))."""
    start = np.asarray(start, dtype=np.int64)
    if model_type == "snv":
        return start - radius
    return start - radius + 1


def window_size(radius: int, local_order: int = 1,
                model_type: str = "snv") -> int:
    """Number of encoded columns in a window."""
    base = 2 * radius + (1 if model_type == "snv" else 0)
    return base - (local_order - 1)


def gather_windows(codes: np.ndarray, starts: np.ndarray, width: int,
                   neg_strand: np.ndarray) -> np.ndarray:
    """Gather (N, width) uint8 code windows from one chromosome.

    Positions outside the chromosome become N; rows flagged in
    ``neg_strand`` are reverse-complemented."""
    starts = np.asarray(starts, dtype=np.int64)
    n = len(codes)
    idx = starts[:, None] + np.arange(width, dtype=np.int64)[None, :]
    in_range = (idx >= 0) & (idx < n)
    out = np.where(in_range, codes[np.clip(idx, 0, max(n - 1, 0))], N_CODE)
    out = out.astype(np.uint8, copy=False)
    neg_strand = np.asarray(neg_strand, dtype=bool)
    if neg_strand.any():
        out[neg_strand] = COMPLEMENT[out[neg_strand]][:, ::-1]
    return out


def kmer_ids(windows: np.ndarray, k: int) -> np.ndarray:
    """Overlapping k-mers as radix-4 ids, (N, W - k + 1) int32; a k-mer
    holding an ambiguous base gets the padding id ``4**k``."""
    digits = DIGIT_TABLE[windows].astype(np.int32)
    n, w = digits.shape
    if k == 1:
        return digits
    cols = w - k + 1
    ids = np.zeros((n, cols), dtype=np.int32)
    bad = np.zeros((n, cols), dtype=bool)
    for d in range(k):
        sl = digits[:, d:d + cols]
        ids = ids * 4 + np.where(sl < 0, 0, sl)
        bad |= sl < 0
    ids[bad] = 4 ** k
    return ids


def order1_local(windows: np.ndarray) -> np.ndarray:
    """Order-1 local digits with ambiguity clamped to 0, int8."""
    d = DIGIT_TABLE[windows]
    return np.where(d >= 0, d, 0).astype(np.int8)


def check_snv_mid_base(windows: np.ndarray, radius: int) -> None:
    """All focal (mid) bases of a segment must be identical, else the
    BED/genome pairing is wrong."""
    mid = DIGIT_TABLE[windows[:, radius]]
    if len(mid) and np.unique(mid).shape[0] != 1:
        raise ValueError(
            "The positions in the input BED file have different bases "
            "(A/T and C/G mixed)! The ref_genome or input BED file could "
            "be wrong.")


def local_headers(local_radius: int, local_order: int,
                  model_type: str) -> list:
    """Column names for local features."""
    if local_order == 1:
        ups = [f"us{local_radius - i}" for i in range(local_radius)]
        dns = [f"ds{i + 1}" for i in range(local_radius)]
        if model_type == "snv":
            return ups + ["mid"] + dns
        return ups + dns
    n = window_size(local_radius, local_order, model_type)
    return [f"cat{i + 1}" for i in range(n)]
