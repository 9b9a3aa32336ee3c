"""Continuous genome tracks, the reference's bigWig features (counterpart
of ``mural_tpu/genome/tracks.py``).

A track is held as per-chromosome two-level prefix sums:

- **block prefixes**: ``float64`` running sums every ``K=4096`` bases,
  always in RAM;
- **in-block sums**: ``float32`` partial sums that restart each block
  (at most 4096 addends), memmapped from an on-disk cache for bedGraph
  inputs, so resident memory stays bounded at any genome size.

``sum(lo, hi) = S(hi) - S(lo)`` with ``S(p) = block_prefix[p // K] +
inblock[p]``: a mean over sites is two gathers, and a per-base window
(the distal track channels) is ``S`` differenced over a (sites, width+1)
grid.

Inputs: bedGraph / 4-column text (``chrom start end value``; whitespace
separated, ``#`` comments and ``track`` lines skipped, ``.gz`` read;
chromosome names stay strings), ``.npz`` archives of per-chromosome
per-base values, and ``.bw`` only with pyBigWig installed.  The cache
(``<path>.mural_cache/``: ``meta.json``, ``<chrom>.blocks.npy``,
``<chrom>.inblock.npy``) has the JAX package's layout and fingerprint, so
a cache written by either package loads in the other.  The track list of
``--bw_paths`` has rows ``path name [radius]`` (``#`` comments), the
radius defaulting to ``local_radius``.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mural_tpu_torch import native
from mural_tpu_torch.genome.encode import expanded_start

_K = 4096                    # block size (bases per float32 restart)
_BUILD_CHUNK = 1 << 22       # streaming build granularity (multiple of K)


def _new_inblock(chrom: str, n: int, cache_dir: Optional[str]):
    if cache_dir is None:
        return np.empty(n, dtype=np.float32)
    os.makedirs(cache_dir, exist_ok=True)
    return np.lib.format.open_memmap(
        os.path.join(cache_dir, f"{chrom}.inblock.npy"), mode="w+",
        dtype=np.float32, shape=(n,))


def _fill_chunk(block_prefix, inblock, c0, c1, running, cum0):
    """Store the prefix sums ``running + cum0[j]`` (``cum0[j]`` = sum of
    values[c0 : c0+j)) of bases [c0, c1) as block prefixes and in-block
    remainders."""
    bs = np.arange(c0 // _K, -(-c1 // _K))
    block_prefix[bs] = running + cum0[np.minimum(bs * _K - c0, c1 - c0)]
    idx = np.arange(c0, c1)
    inblock[c0:c1] = (running + cum0[idx - c0]
                      - block_prefix[idx // _K]).astype(np.float32)


class PrefixTrack:
    """One track: ``chroms[c] = (block_prefix float64 [n_blocks + 1],
    inblock float32 [n])``; ``block_prefix[-1]`` is the total."""

    def __init__(self, chroms: Dict[str, Tuple[np.ndarray, np.ndarray]]):
        self.chroms = chroms

    @classmethod
    def from_intervals(cls, intervals: Dict[str, tuple],
                       cache_dir: Optional[str] = None) -> "PrefixTrack":
        """Build from per-chromosome ``(starts, ends, values)``;
        overlapping intervals add.  Memory during the build is bounded by
        ``_BUILD_CHUNK`` bases."""
        chroms = {}
        for chrom, (starts, ends, vals) in intervals.items():
            starts = np.asarray(starts, dtype=np.int64)
            ends = np.asarray(ends, dtype=np.int64)
            vals = np.asarray(vals, dtype=np.float64)
            n = int(ends.max()) if len(ends) else 0
            block_prefix = np.zeros(-(-n // _K) + 1, dtype=np.float64)
            inblock = _new_inblock(chrom, n, cache_dir)
            running = 0.0
            for c0 in range(0, n, _BUILD_CHUNK):
                c1 = min(c0 + _BUILD_CHUNK, n)
                delta = np.zeros(c1 - c0 + 1, dtype=np.float64)
                s = np.clip(starts, c0, c1) - c0
                e = np.clip(ends, c0, c1) - c0
                keep = s < e
                np.add.at(delta, s[keep], vals[keep])
                np.add.at(delta, e[keep], -vals[keep])
                # interval deltas -> per-base values -> prefix sums
                cum0 = np.concatenate(
                    [[0.0], np.cumsum(np.cumsum(delta[:-1]))])
                _fill_chunk(block_prefix, inblock, c0, c1, running, cum0)
                running += cum0[-1]
            block_prefix[-1] = running
            chroms[chrom] = (block_prefix, inblock)
        return cls(chroms)

    @classmethod
    def from_values(cls, values: Dict[str, np.ndarray],
                    cache_dir: Optional[str] = None) -> "PrefixTrack":
        """Build from dense per-base values (NaN reads 0), in chunks of
        ``_BUILD_CHUNK`` bases."""
        chroms = {}
        for chrom, v in values.items():
            v = np.asarray(v)
            n = len(v)
            block_prefix = np.zeros(-(-n // _K) + 1, dtype=np.float64)
            inblock = _new_inblock(chrom, n, cache_dir)
            running = 0.0
            for c0 in range(0, n, _BUILD_CHUNK):
                c1 = min(c0 + _BUILD_CHUNK, n)
                part = np.nan_to_num(v[c0:c1].astype(np.float64), nan=0.0)
                cum0 = np.concatenate([[0.0], np.cumsum(part)])
                _fill_chunk(block_prefix, inblock, c0, c1, running, cum0)
                running += cum0[-1]
            block_prefix[-1] = running
            chroms[chrom] = (block_prefix, inblock)
        return cls(chroms)

    @classmethod
    def load(cls, path: str,
             cache_dir: Optional[str] = None) -> "PrefixTrack":
        """Load a track file through its cache (default
        ``<path>.mural_cache`` for every input but ``.npz``), building
        and writing the cache when it is missing or stale."""
        if cache_dir is None and not path.endswith(".npz"):
            cache_dir = path + ".mural_cache"
        if cache_dir is not None:
            cached = cls._load_cache(path, cache_dir)
            if cached is not None:
                return cached
        if path.endswith((".bw", ".bigWig", ".bigwig")):
            try:
                import pyBigWig
            except ImportError:
                raise ImportError(
                    f"{path}: .bw tracks need pyBigWig, which is not "
                    "installed; convert to bedGraph (chrom start end "
                    "value) or .npz instead")
            bw = pyBigWig.open(path)
            track = cls.from_values(
                {c: np.nan_to_num(bw.values(c, 0, n, numpy=True), nan=0.0)
                 for c, n in bw.chroms().items()}, cache_dir)
        elif path.endswith(".npz"):
            data = np.load(path)
            track = cls.from_values({k: data[k] for k in data.files},
                                    cache_dir)
        else:
            track = cls.from_intervals(read_bedgraph(path), cache_dir)
        if cache_dir is not None:
            track._write_cache_meta(path, cache_dir)
        return track

    @staticmethod
    def _fingerprint(path: str) -> dict:
        st = os.stat(path)
        return {"src": os.path.abspath(path), "mtime": st.st_mtime,
                "size": st.st_size, "block": _K}

    def _write_cache_meta(self, path: str, cache_dir: str) -> None:
        os.makedirs(cache_dir, exist_ok=True)
        for chrom, (bp, ib) in self.chroms.items():
            np.save(os.path.join(cache_dir, f"{chrom}.blocks.npy"), bp)
            if not isinstance(ib, np.memmap):
                mm = np.lib.format.open_memmap(
                    os.path.join(cache_dir, f"{chrom}.inblock.npy"),
                    mode="w+", dtype=np.float32, shape=ib.shape)
                mm[:] = ib
                self.chroms[chrom] = (bp, mm)
        meta = self._fingerprint(path)
        meta["chroms"] = sorted(self.chroms)
        tmp = os.path.join(cache_dir, "meta.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(meta, fh)
        os.replace(tmp, os.path.join(cache_dir, "meta.json"))

    @classmethod
    def _load_cache(cls, path: str,
                    cache_dir: str) -> Optional["PrefixTrack"]:
        """The cached track, or None when the cache is missing, unreadable
        or was written for another version of the file."""
        try:
            with open(os.path.join(cache_dir, "meta.json")) as fh:
                meta = json.load(fh)
        except (OSError, ValueError):
            return None
        fp = cls._fingerprint(path)
        if (meta.get("block") != _K or meta.get("mtime") != fp["mtime"]
                or meta.get("size") != fp["size"]):
            return None
        chroms = {}
        for chrom in meta.get("chroms", []):
            bp_p = os.path.join(cache_dir, f"{chrom}.blocks.npy")
            ib_p = os.path.join(cache_dir, f"{chrom}.inblock.npy")
            if not (os.path.exists(bp_p) and os.path.exists(ib_p)):
                return None
            chroms[chrom] = (np.load(bp_p), np.load(ib_p, mmap_mode="r"))
        return cls(chroms)

    def _prefix(self, chrom: str, p: np.ndarray) -> np.ndarray:
        """S(p) = sum of values[0:p) for int positions ``p`` (clipped to
        [0, n])."""
        bp, ib = self.chroms[chrom]
        n = len(ib)
        p = np.clip(p, 0, n)
        inner = np.asarray(ib[np.minimum(p, max(n - 1, 0))],
                           dtype=np.float64) if n else 0.0
        return np.where(p >= n, bp[-1], bp[p // _K] + inner)

    def mean_ranges(self, chrom: str, starts: np.ndarray,
                    stops: np.ndarray) -> np.ndarray:
        """float64 mean over each [start, stop) clipped to the chromosome;
        0 for an empty range or an unknown chromosome.  One native pass
        over the sites (:func:`mural_tpu_torch.native.track_mean`)."""
        if chrom not in self.chroms:
            return np.zeros(len(starts), dtype=np.float64)
        block_prefix, inblock = self.chroms[chrom]
        return native.track_mean(block_prefix, inblock, starts, stops, _K)

    def mean_ranges_reference(self, chrom: str, starts: np.ndarray,
                              stops: np.ndarray) -> np.ndarray:
        """Plain numpy version of :meth:`mean_ranges` (the same float64
        arithmetic)."""
        starts = np.asarray(starts, dtype=np.int64)
        stops = np.asarray(stops, dtype=np.int64)
        if chrom not in self.chroms:
            return np.zeros(len(starts), dtype=np.float64)
        n = len(self.chroms[chrom][1])
        lo = np.clip(starts, 0, n)
        hi = np.clip(stops, 0, n)
        width = hi - lo
        total = self._prefix(chrom, hi) - self._prefix(chrom, lo)
        return np.where(width > 0, total / np.maximum(width, 1), 0.0)

    def mean(self, chrom: str, start: int, stop: int) -> float:
        return float(self.mean_ranges(chrom, np.asarray([start]),
                                      np.asarray([stop]))[0])

    def window_values(self, chrom: str, starts: np.ndarray, width: int,
                      neg: Optional[np.ndarray] = None) -> np.ndarray:
        """(n_sites, width) float32 per-base values, 0 outside the
        chromosome; rows with ``neg`` set come back reversed, aligned with
        the reverse-complemented one-hot.  Values are ``S(p+1) - S(p)``
        of float32 in-block sums: about 1e-4 of the block's mean
        magnitude absolute."""
        starts = np.asarray(starts, dtype=np.int64)
        if chrom not in self.chroms:
            return np.zeros((len(starts), width), dtype=np.float32)
        grid = starts[:, None] + np.arange(width + 1)[None, :]
        s = self._prefix(chrom, grid.ravel()).reshape(grid.shape)
        vals = np.diff(s, axis=1).astype(np.float32)
        if neg is not None and np.any(neg):
            neg = np.asarray(neg, bool)
            vals[neg] = vals[neg, ::-1]
        return vals


def read_bedgraph(path: str) -> Dict[str, tuple]:
    """``{chrom: (starts int64, ends int64, values float64)}`` of a
    bedGraph / 4-column text file, chromosomes in order of first
    appearance; columns past the fourth are ignored."""
    opener = gzip.open if path.endswith(".gz") else open
    chroms: List[str] = []
    cols: List[List[str]] = [[], [], []]
    with opener(path, "rt") as fh:
        for line in fh:
            fields = line.split("#", 1)[0].split()
            if not fields or fields[0] == "track":
                continue
            if len(fields) < 4:
                raise ValueError(f"{path}: bedGraph row with fewer than 4 "
                                 f"columns: {line.rstrip()!r}")
            chroms.append(fields[0])
            for col, value in zip(cols, fields[1:4]):
                col.append(value)
    chrom_arr = np.asarray(chroms, dtype=object)
    starts = np.asarray(cols[0]).astype(np.int64)
    ends = np.asarray(cols[1]).astype(np.int64)
    values = np.asarray(cols[2]).astype(np.float64)
    out = {}
    for chrom in dict.fromkeys(chroms):
        sel = chrom_arr == chrom
        out[chrom] = (starts[sel], ends[sel], values[sel])
    return out


def read_track_list(path: str, default_radius: int):
    """A ``--bw_paths`` file -> (files, names, radii); a row without a
    radius takes ``default_radius``.  An empty file gives empty lists."""
    files: List[str] = []
    names: List[str] = []
    radii: List[int] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            files.append(parts[0])
            names.append(parts[1] if len(parts) > 1 else parts[0])
            radii.append(int(parts[2]) if len(parts) > 2
                         else default_radius)
    return files, names, radii


class TrackSet:
    """The tracks of one ``--bw_paths`` list, each with its radius."""

    def __init__(self, files: Sequence[str], names: Sequence[str],
                 radii: Sequence[int], cache_dir: Optional[str] = None):
        self.files = list(files)
        self.names = list(names)
        self.radii = list(radii)
        self.tracks = [PrefixTrack.load(f, cache_dir) for f in files]

    @classmethod
    def from_list(cls, path: str,
                  default_radius: int) -> Optional["TrackSet"]:
        """The tracks of a ``--bw_paths`` list file, or None when it
        lists none."""
        files, names, radii = read_track_list(path, default_radius)
        return cls(files, names, radii) if files else None

    def __len__(self):
        return len(self.tracks)

    def mean_over_sites(self, chroms: Sequence[str], starts: np.ndarray,
                        stops: np.ndarray,
                        model_type: str = "snv") -> np.ndarray:
        """(n_sites, n_tracks) float64 means over each site's window
        expanded by the track's radius."""
        chrom_arr = np.asarray(chroms)
        starts = np.asarray(starts, dtype=np.int64)
        stops = np.asarray(stops, dtype=np.int64)
        out = np.zeros((len(starts), len(self.tracks)), dtype=np.float64)
        for chrom in np.unique(chrom_arr) if len(chrom_arr) else []:
            sel = np.nonzero(chrom_arr == chrom)[0]
            for j, (tr, r) in enumerate(zip(self.tracks, self.radii)):
                out[sel, j] = tr.mean_ranges(
                    str(chrom), expanded_start(starts[sel], r, model_type),
                    stops[sel] + r)
        return out

    def distal_windows(self, chrom: str, starts: np.ndarray, width: int,
                       neg: Optional[np.ndarray] = None) -> np.ndarray:
        """(n_sites, width, n_tracks) float32 per-base values: the distal
        track channels."""
        out = np.empty((len(starts), width, len(self.tracks)),
                       dtype=np.float32)
        for j, tr in enumerate(self.tracks):
            out[:, :, j] = tr.window_values(chrom, starts, width, neg)
        return out
