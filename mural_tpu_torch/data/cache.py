"""On-disk site-table cache, ``--with_h5`` (counterpart of
``mural_tpu/data/cache.py``).

One HDF5 file next to the BED (or under ``--h5f_path``) holds the
:class:`~mural_tpu_torch.data.dataset.SiteDataset` per-site arrays and
segment offsets under a content-addressed name; it goes stale with the
BED's mtime, the site count and the encoding parameters, as the
reference's H5 pre-encoding does (MuRaL/data/preprocessing.py:191-353).
Distal windows are never cached: they are gathered from uint8 codes per
batch.

``n_files > 1`` (``--n_h5_files``) writes the per-site arrays as N
row-shards in N spawned processes, then the master file with the shard
manifest, the global attributes and the segment offsets; loads read the
shards back on a thread pool.  Files are read and written by
:mod:`mural_tpu_torch.data.h5lite` (no h5py), in the JAX package's
format: a cache written by either package loads in the other.

Every file goes through a temporary name unique to its process and
thread, so concurrent writers of one cache (the ranks of ``train
--dp_devices``, concurrent trials) each leave a complete, loadable cache.
This module imports no torch at module level, so a spawned shard writer
starts without it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mural_tpu_torch.data import h5lite


def _track_fingerprint(tracks, seq_only: bool) -> str:
    """The continuous features' configuration: the cache is not shared
    across runs with other tracks or ``seq_only``, and goes stale when a
    track file changes (the reference's bw-name-suffixed H5 names and
    mtime check, preprocessing.py:191-204, 322-346)."""
    import hashlib
    parts = [f"seq_only={bool(seq_only)}"]
    if tracks is not None and len(tracks) > 0:
        for name, radius, tr in zip(tracks.names, tracks.radii,
                                    getattr(tracks, "files",
                                            [None] * len(tracks.names))):
            parts.append(f"{name}:{radius}:{tr}")
        for f in getattr(tracks, "files", []):
            try:
                parts.append(str(os.lstat(f).st_mtime))
            except OSError:
                parts.append("?")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:10]


def cache_path(bed_file: str, central_bp: int, local_radius: int,
               local_order: int, distal_radius: int, model_type: str,
               cache_dir: Optional[str] = None, tracks=None,
               seq_only: bool = False) -> str:
    """Content-addressed cache name (ref ``get_h5f_path``:191-204)."""
    name = (f"{os.path.basename(bed_file)}.local_{local_radius}_"
            f"{local_order}.distal_{distal_radius}.segment_{central_bp}"
            f".{model_type}.{_track_fingerprint(tracks, seq_only)}"
            f".sites.h5")
    base = cache_dir or os.path.dirname(os.path.abspath(bed_file))
    return os.path.join(base, name)


_SITE_ARRAYS = ["chrom_id", "start", "stop", "strand_neg", "y",
                "local1", "cat"]
_ARRAYS = _SITE_ARRAYS + ["seg_offsets"]


def _shard_path(path: str, k: int, n: int) -> str:
    return f"{path}.part{k:02d}of{n:02d}"


def _write_shard(path: str, arrays: dict) -> None:
    """Write one row-shard (in a spawned worker process, or inline)."""
    h5lite.write(path, {"n_rows": len(arrays[_SITE_ARRAYS[0]])}, arrays)


def save_dataset_cache(ds, path: str, n_files: int = 1) -> None:
    """Write the cache; ``n_files > 1`` writes N row-shards in parallel
    spawned processes (gzip is the serial cost at scale), then the
    master, LAST, so that its existence implies complete shards."""
    n_files = max(1, int(n_files))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    attrs = {"n_sites": ds.n_sites, "model_type": ds.model_type,
             "chrom_names": np.array(ds.chrom_names, dtype="S"),
             "n_files": n_files}
    if n_files > 1:
        from concurrent.futures import ProcessPoolExecutor
        from concurrent.futures.process import BrokenProcessPool
        import multiprocessing as mp
        bounds = np.linspace(0, ds.n_sites, n_files + 1).astype(np.int64)
        shards = [_shard_path(path, k, n_files) for k in range(n_files)]

        def slice_of(k):
            lo, hi = bounds[k], bounds[k + 1]
            arrays = {name: getattr(ds, name)[lo:hi]
                      for name in _SITE_ARRAYS}
            if ds.cont is not None:
                arrays["cont"] = ds.cont[lo:hi]
            return arrays

        try:
            with ProcessPoolExecutor(
                    max_workers=min(n_files, os.cpu_count() or 1),
                    mp_context=mp.get_context("spawn")) as pool:
                futs = [pool.submit(_write_shard, sp, slice_of(k))
                        for k, sp in enumerate(shards)]
                for f in futs:
                    f.result()      # re-raises a child's OSError as-is
        except (ValueError, BrokenProcessPool):
            # no spawn context, or a worker died: the serial fallback
            # still surfaces real I/O errors
            for k, sp in enumerate(shards):
                _write_shard(sp, slice_of(k))
        attrs["shard_rows"] = bounds[1:] - bounds[:-1]
        datasets = {"seg_offsets": ds.seg_offsets}
    else:
        datasets = {name: getattr(ds, name) for name in _ARRAYS}
        if ds.cont is not None:
            datasets["cont"] = ds.cont
    h5lite.write(path, attrs, datasets)


def _master_shards(attrs, path: str):
    """Shard paths and row counts of a master file (empty for n=1)."""
    n_files = int(attrs.get("n_files", 1))
    if n_files <= 1:
        return []
    rows = [int(r) for r in attrs["shard_rows"]]
    return [(_shard_path(path, k, n_files), rows[k])
            for k in range(n_files)]


def is_cache_fresh(path: str, bed_file: str, n_sites_hint=None) -> bool:
    """mtime and site-count staleness check (ref generate_h5fv2:322-346);
    a sharded cache also checks every shard's existence, mtime and row
    count against the master's manifest.  A file the reader cannot read
    is stale."""
    if not os.path.exists(path):
        return False
    try:
        bed_mtime = os.lstat(bed_file).st_mtime
        if bed_mtime >= os.lstat(path).st_mtime:
            return False
        attrs, datasets = h5lite.read(path, names=())
        if n_sites_hint is not None and attrs["n_sites"] != n_sites_hint:
            return False
        shards = _master_shards(attrs, path)
        if not shards:
            return all(name in datasets for name in _ARRAYS)
        if "seg_offsets" not in datasets:
            return False
        for sp, n_rows in shards:
            if not os.path.exists(sp) or \
                    bed_mtime >= os.lstat(sp).st_mtime:
                return False
            s_attrs, s_datasets = h5lite.read(sp, names=())
            if s_attrs.get("n_rows") != n_rows or \
                    not all(name in s_datasets for name in _SITE_ARRAYS):
                return False
        return True
    except OSError:
        return False


def load_dataset_cache(path: str, genome, central_bp: int,
                       local_radius: int, local_order: int,
                       distal_radius: int):
    from mural_tpu_torch.data.dataset import SiteDataset
    attrs, datasets = h5lite.read(path, names=None)
    model_type = attrs["model_type"]
    if hasattr(model_type, "decode"):
        model_type = model_type.decode()
    chrom_names = [c.decode() for c in attrs["chrom_names"]]
    shards = _master_shards(attrs, path)
    arrays = dict(datasets)
    cont = arrays.pop("cont", None)
    if shards:
        from concurrent.futures import ThreadPoolExecutor

        def read_shard(sp):
            return h5lite.read(sp)[1]

        with ThreadPoolExecutor(max_workers=min(8, len(shards))) as tp:
            parts = list(tp.map(read_shard, [sp for sp, _ in shards]))
        for name in _SITE_ARRAYS:
            arrays[name] = np.concatenate([p[name] for p in parts])
        if "cont" in parts[0]:
            cont = np.concatenate([p["cont"] for p in parts])
    return SiteDataset(
        model_type=str(model_type),
        local_radius=local_radius,
        local_order=local_order,
        distal_radius=distal_radius,
        central_bp=central_bp,
        chrom_names=chrom_names,
        chrom_codes=[genome[c] for c in chrom_names],
        chrom_id=arrays["chrom_id"],
        start=arrays["start"],
        stop=arrays["stop"],
        strand_neg=arrays["strand_neg"].astype(bool),
        y=arrays["y"],
        local1=arrays["local1"],
        cat=arrays["cat"],
        cont=cont,
        seg_offsets=arrays["seg_offsets"],
    )


def prepare_dataset_cached(bed_file: str, genome, central_bp: int,
                           local_radius: int, local_order: int,
                           distal_radius: int, model_type: str,
                           cache_dir: Optional[str] = None, tracks=None,
                           seq_only: bool = False, printer=print,
                           bw_distal: bool = False, n_files: int = 1):
    """``prepare_dataset`` with a read-through cache (the ``--with_h5``
    path).  ``n_files`` (``--n_h5_files``) shards the cache write; a
    fresh cache is taken whatever its shard count (the master's manifest
    decides).  Per-base distal track values are never cached; a load
    re-attaches the track set."""
    from mural_tpu_torch.data.dataset import prepare_dataset
    from mural_tpu_torch.genome.fasta import Genome
    if isinstance(genome, str):
        genome = Genome.from_fasta(genome)
    path = cache_path(bed_file, central_bp, local_radius, local_order,
                      distal_radius, model_type, cache_dir,
                      tracks=tracks, seq_only=seq_only)
    if is_cache_fresh(path, bed_file):
        printer("using cached site encodings:", path)
        ds = load_dataset_cache(path, genome, central_bp, local_radius,
                                local_order, distal_radius)
        if bw_distal and tracks is not None and len(tracks) > 0:
            ds.distal_tracks = tracks
        return ds
    ds = prepare_dataset(bed_file, genome, central_bp=central_bp,
                         local_radius=local_radius,
                         local_order=local_order,
                         distal_radius=distal_radius,
                         model_type=model_type, tracks=tracks,
                         seq_only=seq_only, bw_distal=bw_distal)
    try:
        save_dataset_cache(ds, path, n_files=n_files)
        printer(f"wrote site-encoding cache ({max(1, n_files)} "
                f"file(s)):", path)
    except OSError as e:
        printer("Warning: could not write cache:", e)
    return ds
