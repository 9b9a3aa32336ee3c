"""Segment-pool batching with fixed batch shapes (counterpart of
``mural_tpu/data/batcher.py``).

``sampled_segments`` segments are pooled, optionally shuffled, and re-cut
into ``batch_size`` batches; a short remainder is carried into the next
pool.  The final remainder is padded and masked (``pad_final``) or
dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from mural_tpu_torch.data.dataset import SiteDataset


@dataclass
class Batch:
    y: np.ndarray            # (B,) int32
    cat: np.ndarray          # (B, K) int32
    distal: np.ndarray       # (B, W) uint8 genome codes
    n_valid: int
    rows: np.ndarray         # (B,) int64 dataset row ids (-1 for padding)
    cont: Optional[np.ndarray] = None           # (B, n_cont) float32
    distal_tracks: Optional[np.ndarray] = None  # (B, W, n_tracks) float32


def iter_batch_rows(ds: SiteDataset, sampled_segments: int,
                    batch_size: int, shuffle: bool = True,
                    rng: Optional[np.random.Generator] = None,
                    pad_final: bool = False):
    """Yield ``(rows, n_valid)`` pairs in segment-pool order.  Padding
    rows (with ``pad_final``) are row id 0, ``n_valid`` marks the real
    prefix."""
    if rng is None:
        rng = np.random.default_rng()
    n_seg = ds.n_segments
    seg_order = np.arange(n_seg)
    if shuffle:
        rng.shuffle(seg_order)

    carry = np.empty(0, dtype=np.int64)
    for pool_start in range(0, n_seg, sampled_segments):
        segs = seg_order[pool_start:pool_start + sampled_segments]
        pool = np.concatenate([carry] + [ds.segment_rows(s) for s in segs])
        if shuffle:
            rng.shuffle(pool)
        n_full = len(pool) // batch_size
        for b in range(n_full):
            yield pool[b * batch_size:(b + 1) * batch_size], batch_size
        carry = pool[n_full * batch_size:]

    if len(carry) and pad_final:
        pad = np.zeros(batch_size - len(carry), dtype=np.int64)
        yield np.concatenate([carry, pad]), len(carry)


def shard_batch_rows(rows: np.ndarray, n_valid: int, shard: slice):
    """The ``shard`` rows of a batch and how many of them are real (the
    real rows of a padded batch are its first ``n_valid``)."""
    lo, hi = shard.start, shard.stop
    return rows[lo:hi], min(max(n_valid - lo, 0), hi - lo)


def segment_pool_batches(ds: SiteDataset, sampled_segments: int,
                         batch_size: int, shuffle: bool = True,
                         rng: Optional[np.random.Generator] = None,
                         pad_final: bool = False,
                         shard: Optional[slice] = None) -> Iterator[Batch]:
    """Yield :class:`Batch` objects; with ``shuffle=False`` the rows come
    in the dataset's segment-emission order.  With ``shard`` (a slice of
    the batch's rows: a data-parallel rank's or an inference replica's)
    the rows are drawn as for the whole batch and only the shard's rows
    are built."""
    for rows, n_valid in iter_batch_rows(ds, sampled_segments, batch_size,
                                         shuffle=shuffle, rng=rng,
                                         pad_final=pad_final):
        if shard is not None:
            rows, n_valid = shard_batch_rows(rows, n_valid, shard)
        y = ds.y[rows].copy()
        cat = ds.cat[rows].copy()
        cont = None if ds.cont is None else ds.cont[rows]
        distal = ds.gather_distal(rows)
        tracks = (ds.gather_distal_track_values(rows)
                  if ds.distal_tracks is not None else None)
        out_rows = rows.copy()
        if n_valid < len(rows):
            for arr in (y, cat, cont, distal, tracks):
                if arr is not None:
                    arr[n_valid:] = 0
            out_rows[n_valid:] = -1
        yield Batch(y=y, cat=cat, distal=distal, n_valid=n_valid,
                    rows=out_rows, cont=cont, distal_tracks=tracks)
