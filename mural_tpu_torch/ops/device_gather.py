"""Window gather and encoding on the chunk's device for genome-wide
prediction (counterpart of ``mural_tpu/ops/device_gather.py``).

Genome-wide prediction uploads each chromosome chunk's codes once (one
1-D uint8 tensor, :func:`iter_code_chunks`) and sends per batch only the
window starts and strands.  The distal one-hot is kernel K4
(:func:`mural_tpu_torch.ops.window_one_hot.window_one_hot`): one pass
from the chunk's codes to the strand-resolved one-hot, the flip of the
forward one-hot on a reverse-strand row,
``one_hot(revcomp(c)) == one_hot(c)[:, ::-1, ::-1]``.  The local ids and
the fused forward's codes are plain torch: windows are rows of the
chunk's ``unfold(0, w, 1)`` view picked by start, so no ``(B, w)`` index
matrix is built, and the complement and digit lookups index 15-entry
tables (the JAX package's iota-matmul lookups and 128-byte row gather
work round TPU gathers, which the card does not need).

The encodes are bit-identical to the host pipeline's
(:mod:`mural_tpu_torch.genome.encode`): the categorical ids as
``kmer_ids`` / ``order1_local`` of the strand-resolved local window, the
distal window as the one-hot (or, for the fused forward, the codes) of
the strand-resolved distal window.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from mural_tpu_torch.device import constant
from mural_tpu_torch.genome import encode as enc
from mural_tpu_torch.genome.fasta import COMPLEMENT, N_CODE, Genome
from mural_tpu_torch.ops.window_one_hot import window_one_hot


def _windows(chunk: torch.Tensor, start: torch.Tensor,
             width: int) -> torch.Tensor:
    """(B, width) rows of the 1-D ``chunk`` at ``start`` (in bounds)."""
    return chunk.unfold(0, width, 1)[start]


def _strand_codes(win: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Reverse-complement the rows of ``win`` (int64 codes) flagged in
    ``neg``."""
    comp = constant(COMPLEMENT, win.device, torch.int64)[win]
    return torch.where(neg[:, None], comp.flip(1), win)


def _local_ids(chunk, lstart, neg, lw: int, local_order: int):
    """int64 categorical ids of the strand-resolved local windows."""
    win = _strand_codes(_windows(chunk, lstart, lw).long(), neg)
    digits = constant(enc.DIGIT_TABLE, win.device, torch.int64)[win]
    if local_order == 1:
        return digits.clamp(min=0)            # enc.order1_local
    cols = lw - local_order + 1
    ids = torch.zeros((win.shape[0], cols), dtype=torch.int64,
                      device=win.device)
    bad = torch.zeros_like(ids, dtype=torch.bool)
    for d in range(local_order):              # enc.kmer_ids
        sl = digits[:, d:d + cols]
        ids = ids * 4 + sl.clamp(min=0)
        bad |= sl < 0
    return torch.where(bad, 4 ** local_order, ids)


def make_batch_encoder(local_radius: int, local_order: int,
                       distal_radius: int, model_type: str = "snv"):
    """Returns (encode_fn, local_window, distal_window).

    ``encode_fn(chunk, lstart, dstart, neg) -> (cat_ids, distal_oh)``:
    ``chunk`` is a padded 1-D uint8 code tensor, ``lstart`` / ``dstart``
    int64 window starts relative to it (in bounds: the caller pads the
    chunk by the window radius) and ``neg`` a bool strand flag, all on
    one device.  ``cat_ids`` is int64 ``(B, n_cat)``, ``distal_oh`` the
    strand-resolved fractional one-hot ``(B, dw, 4)`` float32."""
    lw = enc.window_size(local_radius, 1, model_type)
    dw = enc.window_size(distal_radius, 1, model_type)

    def encode(chunk, lstart, dstart, neg):
        return (_local_ids(chunk, lstart, neg, lw, local_order),
                window_one_hot(chunk, dstart, dw, neg))

    return encode, lw, dw


def make_batch_code_encoder(local_radius: int, local_order: int,
                            distal_radius: int, model_type: str = "snv"):
    """The fused forward's variant (its stem kernel reads codes):
    ``encode_fn(chunk, lstart, dstart, neg) -> (cat_ids, distal_codes)``
    with the distal codes ``(B, dw)`` uint8 reverse-complemented on the
    negative strand."""
    lw = enc.window_size(local_radius, 1, model_type)
    dw = enc.window_size(distal_radius, 1, model_type)

    def encode(chunk, lstart, dstart, neg):
        codes = _strand_codes(_windows(chunk, dstart, dw).long(), neg)
        return (_local_ids(chunk, lstart, neg, lw, local_order),
                codes.to(torch.uint8))

    return encode, lw, dw


def iter_code_chunks(genome: Genome, chrom: str, margin: int,
                     chunk: int = 1 << 22
                     ) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Yield (lo, hi, padded_codes) covering one chromosome.

    ``padded_codes`` has the fixed length ``chunk + 2*margin``: positions
    [margin, margin + (hi-lo)) hold codes[lo:hi], the flanks hold the
    real neighbouring codes where the chromosome continues and N
    elsewhere.  A window start relative to the padded array is
    ``abs_start - lo + margin``."""
    codes = genome[chrom]
    n = len(codes)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        padded = np.full(chunk + 2 * margin, N_CODE, dtype=np.uint8)
        src_lo = max(lo - margin, 0)
        src_hi = min(hi + margin, n)
        padded[src_lo - lo + margin: src_hi - lo + margin] = \
            codes[src_lo:src_hi]
        yield lo, hi, padded
