"""FASTA loading into per-chromosome uint8 code arrays (counterpart of
``mural_tpu/genome/fasta.py``).

Code space (15 classes; anything unrecognised maps to N):
0 A, 1 C, 2 G, 3 T (U too), 4 R, 5 Y, 6 M, 7 S, 8 W, 9 K, 10 B, 11 D,
12 H, 13 V, 14 N.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Dict, Iterator, Tuple

import numpy as np

A, C, G, T = 0, 1, 2, 3
N_CODE = 14
NUM_CODES = 15

_SYMBOLS = "ACGTRYMSWKBDHVN"

_BYTE_LUT = np.full(256, N_CODE, dtype=np.uint8)
for _i, _ch in enumerate(_SYMBOLS):
    _BYTE_LUT[ord(_ch)] = _i
    _BYTE_LUT[ord(_ch.lower())] = _i
_BYTE_LUT[ord("U")] = T
_BYTE_LUT[ord("u")] = T

# A<->T, C<->G, R<->Y, M<->K, S<->S, W<->W, B<->V, D<->H, N<->N
COMPLEMENT = np.array([T, G, C, A, 5, 4, 9, 7, 8, 6, 13, 12, 11, 10, 14],
                      dtype=np.uint8)

_CODE_TO_CHAR = np.frombuffer(_SYMBOLS.encode(), dtype=np.uint8)


def encode_sequence(seq: "str | bytes") -> np.ndarray:
    """Encode a nucleotide string into a uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return _BYTE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_sequence(codes: np.ndarray) -> str:
    """Inverse of :func:`encode_sequence` (codes -> upper-case string)."""
    return _CODE_TO_CHAR[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Stream (name, sequence) records from a FASTA file (.gz ok)."""
    name = None
    chunks = []
    with _open_maybe_gzip(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


class Genome:
    """A reference genome held as per-chromosome uint8 code arrays."""

    def __init__(self, chroms: Dict[str, np.ndarray]):
        self.chroms = chroms

    @classmethod
    def from_fasta(cls, path: str) -> "Genome":
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return cls({name: encode_sequence(seq)
                    for name, seq in iter_fasta(path)})

    def __contains__(self, chrom: str) -> bool:
        return chrom in self.chroms

    def __getitem__(self, chrom: str) -> np.ndarray:
        return self.chroms[chrom]

    def names(self):
        return list(self.chroms.keys())
