"""Sorted-BED reading and segment grouping (counterpart of
``mural_tpu/genome/bed.py``)."""

from __future__ import annotations

import gzip
from typing import List

import numpy as np


class BedFile:
    """A parsed BED file held as column arrays."""

    def __init__(self, chroms: List[str], start: np.ndarray, stop: np.ndarray,
                 label: np.ndarray, strand: np.ndarray, path: str = ""):
        self.chrom = chroms                  # list[str], len N
        self.start = start                   # int64 (0-based)
        self.stop = stop                     # int64
        self.label = label                   # int32 (BED score column)
        self.strand = strand                 # bool, True == '-'
        self.path = path

    def __len__(self):
        return len(self.start)

    @classmethod
    def read(cls, path: str) -> "BedFile":
        opener = gzip.open if path.endswith(".gz") else open
        chroms: List[str] = []
        starts: List[int] = []
        stops: List[int] = []
        labels: List[int] = []
        strands: List[bool] = []
        with opener(path, "rt") as fh:
            for line in fh:
                if not line.strip() or line.startswith(
                        ("#", "track", "browser")):
                    continue
                f = line.split("\t")
                if len(f) < 6:
                    f = line.split()
                if len(f) < 6:
                    raise ValueError(
                        f"BED line needs >=6 fields (chrom start end name "
                        f"score strand): {line!r}")
                chroms.append(f[0])
                starts.append(int(f[1]))
                stops.append(int(f[2]))
                labels.append(int(float(f[4])))
                strands.append(f[5].strip() == "-")
        return cls(chroms, np.asarray(starts, dtype=np.int64),
                   np.asarray(stops, dtype=np.int64),
                   np.asarray(labels, dtype=np.int32),
                   np.asarray(strands, dtype=bool), path=path)


def segment_sites(bed: BedFile, central_bp: int) -> List[np.ndarray]:
    """Group site row indices into single-strand segments.

    The first region opens a window [start, start+central_bp); a
    chromosome change resets it to [1, 1+central_bp); a region starting
    past the window end closes the current segment(s) ('+' rows, then '-'
    rows) and slides the window forward in central_bp steps.  Each
    returned int64 index array is single-strand and in file order."""
    segments: List[np.ndarray] = []
    n = len(bed)
    if n == 0:
        return segments

    pos_rows: List[int] = []
    neg_rows: List[int] = []

    def flush():
        if pos_rows:
            segments.append(np.asarray(pos_rows, dtype=np.int64))
            pos_rows.clear()
        if neg_rows:
            segments.append(np.asarray(neg_rows, dtype=np.int64))
            neg_rows.clear()

    chrom = bed.chrom[0]
    end0 = int(bed.start[0]) + central_bp
    for i in range(n):
        c, s = bed.chrom[i], int(bed.start[i])
        if c != chrom:
            flush()
            chrom = c
            end0 = 1 + central_bp
        if s > end0:
            flush()
            while s > end0:
                end0 += central_bp
        (neg_rows if bed.strand[i] else pos_rows).append(i)
    flush()
    return segments
