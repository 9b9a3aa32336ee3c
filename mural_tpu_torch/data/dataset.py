"""Site dataset: local features, track features and distal gather
metadata (counterpart of ``mural_tpu/data/dataset.py``).

All per-site arrays are in segment emission order, so every segment is a
contiguous row range.  Distal windows are not materialised: batches
gather uint8 code windows on demand (:meth:`SiteDataset.gather_distal`)
and, with distal track channels, the tracks' per-base values over the
same windows (:meth:`SiteDataset.gather_distal_track_values`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from mural_tpu_torch import native
from mural_tpu_torch.genome import encode as enc
from mural_tpu_torch.genome.bed import BedFile, segment_sites
from mural_tpu_torch.genome.fasta import Genome
from mural_tpu_torch.genome.tracks import TrackSet


@dataclass
class SiteDataset:
    model_type: str                 # 'snv' | 'indel'
    local_radius: int
    local_order: int
    distal_radius: int
    central_bp: int

    chrom_names: List[str]
    chrom_codes: List[np.ndarray]

    chrom_id: np.ndarray            # int32
    start: np.ndarray               # int64 (BED start)
    stop: np.ndarray                # int64 (BED stop)
    strand_neg: np.ndarray          # bool
    y: np.ndarray                   # int32 labels
    local1: np.ndarray              # int8 (n, 2r+1|2r) order-1 digits
    cat: np.ndarray                 # int32 (n, n_cat) categorical ids
    cont: Optional[np.ndarray]      # float32 (n, n_cont) track means

    seg_offsets: np.ndarray         # int64 (n_segments + 1,)

    # tracks whose per-base values join the one-hot as extra distal
    # channels (in_channels = 4 + n_cont), or None
    distal_tracks: Optional[TrackSet] = None

    @property
    def n_sites(self) -> int:
        return len(self.start)

    @property
    def n_segments(self) -> int:
        return len(self.seg_offsets) - 1

    @property
    def n_cont(self) -> int:
        return 0 if self.cont is None else self.cont.shape[1]

    @property
    def n_distal_tracks(self) -> int:
        return 0 if self.distal_tracks is None else len(self.distal_tracks)

    @property
    def cat_dims(self) -> List[int]:
        """Max id + 1 per categorical column."""
        return [int(self.cat[:, j].max()) + 1
                for j in range(self.cat.shape[1])]

    @property
    def distal_width(self) -> int:
        return enc.window_size(self.distal_radius, 1, self.model_type)

    def segment_rows(self, seg: int) -> np.ndarray:
        return np.arange(self.seg_offsets[seg], self.seg_offsets[seg + 1])

    def gather_distal(self, rows: np.ndarray) -> np.ndarray:
        """uint8 code windows (len(rows), distal_width) for site rows,
        gathered by the native loop."""
        rows = np.asarray(rows)
        width = self.distal_width
        out = np.empty((len(rows), width), dtype=np.uint8)
        starts = enc.expanded_start(self.start[rows], self.distal_radius,
                                    self.model_type)
        cids = self.chrom_id[rows]
        neg = self.strand_neg[rows]
        for cid in np.unique(cids):
            m = cids == cid
            out[m] = native.gather_windows(self.chrom_codes[cid],
                                           starts[m], width, neg[m])
        return out

    def gather_distal_track_values(self, rows: np.ndarray) -> np.ndarray:
        """float32 (len(rows), distal_width, n_distal_tracks) per-base
        track values over the distal windows; reverse-strand rows come
        back reversed, aligned with their reverse-complemented codes."""
        rows = np.asarray(rows)
        width = self.distal_width
        out = np.empty((len(rows), width, self.n_distal_tracks),
                       dtype=np.float32)
        starts = enc.expanded_start(self.start[rows], self.distal_radius,
                                    self.model_type)
        cids = self.chrom_id[rows]
        neg = self.strand_neg[rows]
        for cid in np.unique(cids):
            m = cids == cid
            out[m] = self.distal_tracks.distal_windows(
                self.chrom_names[cid], starts[m], width, neg[m])
        return out

    def local_frame(self) -> Dict[str, np.ndarray]:
        """Order-1 local columns plus ``mut_type``, as numpy columns (the
        JAX package's pandas frame, ``mural_tpu/data/dataset.py:135``)."""
        cols = enc.local_headers(self.local_radius, 1, self.model_type)
        frame = {name: self.local1[:, i] for i, name in enumerate(cols)}
        frame["mut_type"] = self.y
        return frame

    def subset_segments(self, seg_ids: np.ndarray) -> "SiteDataset":
        """New dataset restricted to the given segments, in sorted order
        (the segment-level train/validation split)."""
        seg_ids = np.sort(np.asarray(seg_ids))
        rows = (np.concatenate([self.segment_rows(s) for s in seg_ids])
                if len(seg_ids) else np.empty(0, dtype=np.int64))
        sizes = [self.seg_offsets[s + 1] - self.seg_offsets[s]
                 for s in seg_ids]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        return dataclasses.replace(
            self, chrom_id=self.chrom_id[rows], start=self.start[rows],
            stop=self.stop[rows], strand_neg=self.strand_neg[rows],
            y=self.y[rows], local1=self.local1[rows], cat=self.cat[rows],
            cont=None if self.cont is None else self.cont[rows],
            seg_offsets=offsets)

    def position_frame(self) -> Dict[str, np.ndarray]:
        """chrom/start/end/strand columns in emission order."""
        return {
            "chrom": np.asarray(self.chrom_names, dtype=object)[
                self.chrom_id],
            "start": self.start,
            "end": self.stop,
            "strand": np.where(self.strand_neg, "-", "+"),
        }


def prepare_dataset(bed: "BedFile | str", genome: "Genome | str",
                    central_bp: int = 300000, local_radius: int = 7,
                    local_order: int = 3, distal_radius: int = 200,
                    distal_order: int = 1, model_type: str = "snv",
                    tracks: Optional[TrackSet] = None,
                    seq_only: bool = False, check_mid: bool = True,
                    bw_distal: bool = False) -> SiteDataset:
    """Build a :class:`SiteDataset` from a BED and a genome.

    ``tracks`` supply the continuous features ``cont``: each track's mean
    over the site's window expanded by its radius.  With ``bw_distal``
    their per-base values also become distal channels.  ``seq_only``
    ignores the tracks."""
    if isinstance(bed, str):
        bed = BedFile.read(bed)
    if isinstance(genome, str):
        genome = Genome.from_fasta(genome)
    if distal_order != 1:
        raise NotImplementedError(
            "distal_order > 1 is reserved in the reference too")

    segments = segment_sites(bed, central_bp)
    perm = (np.concatenate(segments) if segments
            else np.empty(0, dtype=np.int64))
    sizes = np.asarray([len(s) for s in segments], dtype=np.int64)
    seg_offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    chrom_names = genome.names()
    name_to_id = {c: i for i, c in enumerate(chrom_names)}
    try:
        chrom_id = np.asarray([name_to_id[bed.chrom[i]] for i in perm],
                              dtype=np.int32)
    except KeyError as e:
        raise KeyError(f"BED chromosome {e} not found in reference genome")
    start = bed.start[perm]
    stop = bed.stop[perm]
    strand_neg = bed.strand[perm]
    y = bed.label[perm]
    chrom_codes = [genome[c] for c in chrom_names]

    lw = enc.window_size(local_radius, 1, model_type)
    local_starts = enc.expanded_start(start, local_radius, model_type)
    local_windows = np.empty((len(perm), lw), dtype=np.uint8)
    for cid in np.unique(chrom_id):
        m = chrom_id == cid
        local_windows[m] = enc.gather_windows(
            chrom_codes[cid], local_starts[m], lw, strand_neg[m])

    if model_type == "snv" and check_mid:
        for s in range(len(segments)):
            enc.check_snv_mid_base(
                local_windows[seg_offsets[s]:seg_offsets[s + 1]],
                local_radius)

    local1 = enc.order1_local(local_windows)
    cat = (native.kmer_pack(local_windows, local_order) if local_order > 1
           else local1.astype(np.int32))

    use_tracks = tracks is not None and not seq_only and len(tracks) > 0
    cont = None
    if use_tracks:
        cont = tracks.mean_over_sites(
            [bed.chrom[i] for i in perm], start, stop,
            model_type=model_type).astype(np.float32)

    return SiteDataset(
        model_type=model_type, local_radius=local_radius,
        local_order=local_order, distal_radius=distal_radius,
        central_bp=central_bp, chrom_names=chrom_names,
        chrom_codes=chrom_codes, chrom_id=chrom_id, start=start,
        stop=stop, strand_neg=strand_neg, y=y.astype(np.int32),
        local1=local1, cat=cat.astype(np.int32), cont=cont,
        seg_offsets=seg_offsets,
        distal_tracks=tracks if use_tracks and bw_distal else None)
