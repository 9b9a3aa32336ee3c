"""The prediction TSV: ``chrom start end strand mut_type prob0..N``.

``write_tsv`` writes it as predict does (floats ``%.4g``, NaN as an
empty field, gzip when the path ends in ``.gz``); ``read_pred_chunks``
streams it back in chunks of ``CHUNK_ROWS`` rows as numpy columns,
keeping ``chrom`` and ``strand`` as strings (a chromosome named ``1``
stays the string ``'1'``).
"""

from __future__ import annotations

import gzip
import itertools
from typing import Dict, Iterator

import numpy as np

Frame = Dict[str, np.ndarray]

CHUNK_ROWS = 2_000_000


def open_text(path: str, mode: str = "rt"):
    """``open`` that gzips when ``path`` ends in ``.gz``."""
    return gzip.open(path, mode) if path.endswith(".gz") else open(path,
                                                                   mode)


def _fmt(v: float) -> str:
    return "" if np.isnan(v) else "%.4g" % v


def write_tsv(path: str, cols: Frame) -> None:
    """Tab-separated with a header; floats as ``%.4g`` (NaN as an empty
    field), gzip-compressed when ``path`` ends in ``.gz``."""
    names = list(cols)
    prob_names = [n for n in names if n.startswith("prob")]
    probs = np.stack([cols[n] for n in prob_names], axis=1) if prob_names \
        else np.zeros((len(cols["start"]), 0))
    lines = ["\t".join(names)]
    for i in range(len(cols["start"])):
        lines.append("\t".join(
            [str(cols["chrom"][i]), str(cols["start"][i]),
             str(cols["end"][i]), str(cols["strand"][i]),
             str(cols["mut_type"][i])] + [_fmt(v) for v in probs[i]]))
    data = ("\n".join(lines) + "\n").encode()
    with open_text(path, "wb") as fh:
        fh.write(data)


def _floats(values) -> np.ndarray:
    try:
        return np.asarray(values, dtype=np.float64)
    except ValueError:      # empty fields (NaN as written)
        return np.asarray([float(v) if v else np.nan for v in values],
                          dtype=np.float64)


def _columns(header, lines) -> Frame:
    rows = [line.rstrip("\r\n").split("\t") for line in lines]
    for row in rows:
        if len(row) != len(header):
            raise ValueError(f"Expected {len(header)} fields, saw "
                             f"{len(row)} in row {row}")
    cols = list(zip(*rows)) or [()] * len(header)
    out = {}
    for j, name in enumerate(header):
        if j in (0, 3):                 # chrom, strand
            out[name] = np.asarray(cols[j], dtype=str)
        elif j in (1, 2, 4):            # start, end, mut_type
            out[name] = np.asarray(cols[j], dtype=np.int64)
        else:
            out[name] = _floats(cols[j])
    return out


def read_pred_chunks(path: str, n_class: int) -> Iterator[Frame]:
    """Yield the rows of a prediction TSV (plain or gzip) as frames of at
    most ``CHUNK_ROWS`` rows, after the header and column-count checks
    of the reference (calc_kmer_corr.py:209-218).  Blank lines are
    skipped; a file with a header and no rows gives one empty frame."""
    with open_text(path) as fh:
        header = fh.readline().rstrip("\r\n").split("\t")
        if header[0] != "chrom":
            raise ValueError(f"Invalid file header: {header}; first column "
                             "should be 'chrom'")
        if len(header) != n_class + 5:
            raise ValueError(f"Column count mismatch. Expected {n_class + 5} "
                             f"columns, got {len(header)}")
        empty = True
        while lines := list(itertools.islice(fh, CHUNK_ROWS)):
            kept = [line for line in lines if line.strip()]
            if kept:
                empty = False
                yield _columns(header, kept)
        if empty:
            yield _columns(header, [])
