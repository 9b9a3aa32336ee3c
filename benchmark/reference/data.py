"""Plain host encodings of genome windows for the references.

Genome codes are uint8: A C G T = 0 1 2 3, the IUPAC ambiguity codes
R Y M S W K B D H V = 4..13, N = 14 (the FASTA convention of the
measured program, which the benchmark writes its genomes in).  Nothing
here imports the measured program.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 14
BASES = b"ACGTRYMSWKBDHVN"
COMPLEMENT = np.array([T, G, C, A, 5, 4, 9, 7, 8, 6, 13, 12, 11, 10, 14],
                      dtype=np.uint8)
# the fractional one-hot of each code over A, C, G, T
ONE_HOT = np.array([
    [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
    [.5, 0, .5, 0], [0, .5, 0, .5], [.5, .5, 0, 0], [0, .5, .5, 0],
    [.5, 0, 0, .5], [0, 0, .5, .5],
    [0, 1 / 3, 1 / 3, 1 / 3], [1 / 3, 0, 1 / 3, 1 / 3],
    [1 / 3, 1 / 3, 0, 1 / 3], [1 / 3, 1 / 3, 1 / 3, 0],
    [.25, .25, .25, .25]], dtype=np.float64)


def window_start(pos: np.ndarray, radius: int, model_type: str
                 ) -> np.ndarray:
    """First base of a site's window: SNV ``[pos - r, pos + r]``, INDEL
    ``[pos - r + 1, pos + r]``."""
    pos = np.asarray(pos, dtype=np.int64)
    return pos - radius if model_type == "snv" else pos - radius + 1


def window_width(radius: int, model_type: str) -> int:
    return 2 * radius + 1 if model_type == "snv" else 2 * radius


def windows(codes: np.ndarray, pos: np.ndarray, neg: np.ndarray,
            radius: int, model_type: str) -> np.ndarray:
    """(n, width) uint8 windows around ``pos``, N outside the sequence,
    reverse-complemented where ``neg``."""
    width = window_width(radius, model_type)
    idx = (window_start(pos, radius, model_type)[:, None]
           + np.arange(width, dtype=np.int64)[None, :])
    inside = (idx >= 0) & (idx < len(codes))
    out = np.where(inside, codes[np.clip(idx, 0, len(codes) - 1)], N)
    out = out.astype(np.uint8)
    neg = np.asarray(neg, dtype=bool)
    out[neg] = COMPLEMENT[out[neg]][:, ::-1]
    return out


def kmer_ids(win: np.ndarray, k: int) -> np.ndarray:
    """(n, width - k + 1) int64 ids of the overlapping k-mers (radix 4 in
    reading order); a k-mer with an ambiguous base gets ``4 ** k``."""
    digits = win.astype(np.int64)
    digits[win >= 4] = -1
    cols = win.shape[1] - k + 1
    ids = np.zeros((len(win), cols), dtype=np.int64)
    bad = np.zeros((len(win), cols), dtype=bool)
    for d in range(k):
        part = digits[:, d:d + cols]
        ids = ids * 4 + np.maximum(part, 0)
        bad |= part < 0
    ids[bad] = 4 ** k
    return ids


def one_hot(win: np.ndarray) -> np.ndarray:
    """(n, width) codes -> (n, 4, width) float64 one-hot, channels first."""
    return ONE_HOT[win].transpose(0, 2, 1)


def focal_sites(codes: np.ndarray, focal: str):
    """Every site a genome-wide map predicts, in file order: positions
    ascending, '+' where the base is ``focal`` and '-' where it is its
    complement; every position on '+' for ``focal == 'all'``.  Returns
    (positions int64, negative-strand flags)."""
    if focal == "all":
        return np.arange(len(codes), dtype=np.int64), np.zeros(
            len(codes), bool)
    fwd = BASES.index(focal.encode())
    rev = int(COMPLEMENT[fwd])
    pos = np.flatnonzero((codes == fwd) | (codes == rev)).astype(np.int64)
    return pos, codes[pos] == rev
