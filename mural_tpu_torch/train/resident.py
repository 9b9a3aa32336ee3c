"""Device-resident training data (counterpart of
``mural_tpu/train/resident.py``).

The host-fed loop builds and uploads every batch: the SNV step then
waits on the host.  Here the data go to the device once per trial and
the host sends one row array per epoch:

- **arena** (:func:`build_arena`): the union of all sites' distal
  windows, merged into super-intervals per chromosome, as one 1-D uint8
  tensor; each site stores its window start in arena coordinates, and
  positions outside the chromosome hold N, exactly as the host gather;
- **per-site arrays**: labels and k-mer ids in their narrowest integer
  type (cast to int64 per batch on the device), continuous features,
  window starts and strand flags;
- **epoch rows** (:func:`stack_epoch_rows`): the segment-pool order of
  the host path, from the same ``iter_batch_rows`` and the same rng
  draws, as one ``(n_steps, B)`` array uploaded per epoch.

A batch's windows start at its sites' arena starts and are
strand-resolved on the device: the unfused model's one-hot by kernel K4
(``ops/window_one_hot.py``: one pass from the arena's codes, the minus
rows flipped on both axes), the fused stem's codes as rows of
``arena.unfold(0, dw, 1)`` reverse-complemented through the complement
table (``ops/device_gather.py``).  The JAX package's TPU workarounds
(the ``(R, 128)`` row view, the blocked gather, the iota-matmul
complement) are not needed on the card.
:func:`resident_epoch` runs the steps in groups of K
(``train/graphs.py``: one CUDA graph replay per group when K > 1);
:func:`resident_eval` runs validation on padded rows and masks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mural_tpu_torch.data.batcher import iter_batch_rows
from mural_tpu_torch.genome import encode as enc
from mural_tpu_torch.genome.fasta import N_CODE
from mural_tpu_torch.ops.device_gather import _strand_codes, _windows
from mural_tpu_torch.ops.window_one_hot import window_one_hot
from mural_tpu_torch.train.steps import eval_step


def build_arena(ds):
    """Merged-window code arena of a :class:`SiteDataset`.

    Returns ``(arena uint8 (A,), astart (n_sites,))`` where
    ``arena[astart[i]:astart[i] + ds.distal_width]`` is the forward-strand
    window the host gather produces for site i.  ``astart`` is int32 when
    the arena allows it, else int64."""
    dw = ds.distal_width
    gstart = enc.expanded_start(ds.start, ds.distal_radius, ds.model_type)
    astart = np.empty(ds.n_sites, dtype=np.int64)
    pieces = []
    base = 0
    for cid in np.unique(ds.chrom_id) if ds.n_sites else []:
        m = np.where(ds.chrom_id == cid)[0]
        s = gstart[m]
        order = np.argsort(s, kind="stable")
        s_sorted = s[order]
        run_hi = np.maximum.accumulate(s_sorted + dw)
        new = np.empty(len(s_sorted), dtype=bool)
        new[0] = True
        new[1:] = s_sorted[1:] > run_hi[:-1]
        grp = np.cumsum(new) - 1
        glo = s_sorted[new]
        ghi = run_hi[np.concatenate([new[1:], [True]])]
        lens = ghi - glo
        offsets = base + np.concatenate([[0], np.cumsum(lens[:-1])])
        astart[m[order]] = offsets[grp] + (s_sorted - glo[grp])
        # arena position k of interval j holds genome position
        # k + glo[j] - (offsets[j] - base)
        total = int(lens.sum())
        pos = (np.arange(total, dtype=np.int64)
               + np.repeat(glo - (offsets - base), lens))
        codes = ds.chrom_codes[cid]
        n = len(codes)
        pieces.append(np.where((pos >= 0) & (pos < n),
                               codes[np.clip(pos, 0, max(n - 1, 0))],
                               N_CODE).astype(np.uint8))
        base += total
    arena = (np.concatenate(pieces) if pieces
             else np.zeros(dw, dtype=np.uint8))
    if len(arena) < dw:                      # degenerate tiny dataset
        arena = np.concatenate(
            [arena, np.full(dw - len(arena), N_CODE, dtype=np.uint8)])
    if len(arena) < np.iinfo(np.int32).max - dw:
        astart = astart.astype(np.int32)
    return arena, astart


def _smallest_int(a: np.ndarray):
    """Smallest integer dtype that holds the non-negative ``a``."""
    if a.size == 0 or a.max() < 256:
        return np.uint8
    if a.max() < 2 ** 15:
        return np.int16
    return np.int32


def estimate_resident_bytes(ds) -> int:
    """Upper bound on the device bytes of :func:`make_resident`: the arena
    is bounded by the merged-interval union, itself bounded by both the
    genome size and ``n_sites * window``."""
    dw = ds.distal_width
    arena_bound = min(sum(len(c) for c in ds.chrom_codes) + 2 * dw,
                      ds.n_sites * dw + 2 * dw)
    cat_itemsize = np.dtype(_smallest_int(ds.cat)).itemsize
    per_site = (1 + cat_itemsize * ds.cat.shape[1] + 8 + 1
                + (4 * ds.n_cont if ds.cont is not None else 0))
    return arena_bound + per_site * ds.n_sites


@dataclasses.dataclass
class ResidentData:
    """Per-trial device copies of one :class:`SiteDataset`."""
    arena: torch.Tensor           # (A,) uint8 code arena
    y: torch.Tensor               # (n,) uint8 or int32 labels
    cat: torch.Tensor             # (n, K) narrowest integer k-mer ids
    cont: Optional[torch.Tensor]  # (n, C) float32 or None
    astart: torch.Tensor          # (n,) int64 arena window starts
    neg: torch.Tensor             # (n,) bool
    distal_width: int
    n_sites: int

    def batch(self, rows: torch.Tensor, fused_stem: bool):
        """``(B,)`` int64 row ids -> ``(y, cat, distal, cont)``: labels and
        k-mer ids as int64; ``distal`` the strand-resolved codes ``(B, dw)``
        uint8 for the fused stem, else their one-hot ``(B, dw, 4)`` float32
        (kernel K4 on the card)."""
        start, neg = self.astart[rows], self.neg[rows]
        if fused_stem:
            win = _windows(self.arena, start, self.distal_width)
            distal = _strand_codes(win.long(), neg).to(torch.uint8)
        else:
            distal = window_one_hot(self.arena, start, self.distal_width, neg)
        return (self.y[rows].long(), self.cat[rows].long(), distal,
                None if self.cont is None else self.cont[rows])


def make_resident(ds, device) -> Optional[ResidentData]:
    """Build and upload the resident arrays; None when the dataset needs
    the host path (per-base distal track channels)."""
    if ds.distal_tracks is not None:
        return None
    arena, astart = build_arena(ds)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ResidentData(
        arena=put(arena),
        y=put(ds.y.astype(np.uint8 if ds.y.size == 0 or ds.y.max() < 256
                          else np.int32)),
        cat=put(ds.cat.astype(_smallest_int(ds.cat))),
        cont=None if ds.cont is None else put(ds.cont),
        astart=put(astart.astype(np.int64)),
        neg=put(ds.strand_neg.astype(bool)),
        distal_width=ds.distal_width,
        n_sites=ds.n_sites)


def stack_epoch_rows(ds, sampled_segments: int, batch_size: int,
                     shuffle: bool, rng=None, pad_final: bool = False):
    """The epoch's batches as ``(rows (n_steps, B) int32, masks (n_steps,
    B) float32, n_valids)``, in ``segment_pool_batches``' order (the same
    ``iter_batch_rows`` and rng draws); padding rows are row 0."""
    rows_list, n_valids = [], []
    for rows, n_valid in iter_batch_rows(ds, sampled_segments, batch_size,
                                         shuffle=shuffle, rng=rng,
                                         pad_final=pad_final):
        rows_list.append(rows.astype(np.int32))
        n_valids.append(n_valid)
    if not rows_list:
        return (np.zeros((0, batch_size), np.int32),
                np.zeros((0, batch_size), np.float32), [])
    rows = np.stack(rows_list)
    masks = (np.arange(batch_size)[None, :]
             < np.asarray(n_valids)[:, None]).astype(np.float32)
    return rows, masks, n_valids


def upload_rows(rows: np.ndarray, device) -> torch.Tensor:
    """An epoch's ``(n_steps, B)`` rows as int64 on ``device``, copied
    from pinned memory without blocking the host on a CUDA device."""
    t = torch.from_numpy(rows.astype(np.int64))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def resident_batch(res: ResidentData, fused_stem: bool, mask: torch.Tensor):
    """``batch(inputs, i)`` of a :class:`~mural_tpu_torch.train.graphs.
    StepGroups` over resident data: ``inputs`` is ``(rows (k, B),)``, and
    step ``i`` trains on rows ``rows[i]`` with every mask 1."""
    def batch(inputs, i):
        y, cat, distal, cont = res.batch(inputs[0][i], fused_stem)
        return y, cat, distal, mask, cont

    return batch


def resident_epoch(groups, rows: torch.Tensor,
                   scalars: torch.Tensor) -> torch.Tensor:
    """One training epoch over resident data: ``rows`` ``(n_steps, B)``
    int64 on the device, in groups of K of ``groups`` (a ``StepGroups``
    built on :func:`resident_batch`) at ``scalars`` ``(n_steps, 4)``.
    Returns the per-step losses ``(n_steps,)`` on the device."""
    losses = [groups.run(scalars[g:g + groups.k], (rows[g:g + groups.k],))
              for g in range(0, rows.shape[0], groups.k)]
    return (torch.cat(losses) if losses
            else torch.zeros(0, device=rows.device))


@torch.no_grad()
def resident_eval(model: torch.nn.Module, res: ResidentData,
                  rows: torch.Tensor, masks: torch.Tensor,
                  fused_stem: bool):
    """Validation over resident data: ``rows`` and ``masks`` ``(n_steps,
    B)`` on the device -> ``(logits (n_steps, B, n_class), loss sum)``."""
    parts = []
    loss = torch.zeros((), dtype=torch.float32, device=rows.device)
    for i in range(rows.shape[0]):
        y, cat, distal, cont = res.batch(rows[i], fused_stem)
        logits, vloss = eval_step(model, y, cat, distal, masks[i], cont)
        parts.append(logits)
        loss += vloss
    return (torch.stack(parts) if parts else None), loss
