"""The port's site-table cache (``mural_tpu_torch.data.cache``, read and
written by ``data/h5lite.py`` without h5py) against the JAX package's
(``mural_tpu/data/cache.py``, h5py): the same file names, each package
loading the other's caches, single-file and with 4 shards, with arrays
exactly equal to a fresh ``prepare_dataset``; staleness; a cache the
port cannot read taken as stale and rebuilt; concurrent writers of one
cache; and a shard writer that starts without torch."""
import glob
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from mural_tpu.data import cache as jcache
from mural_tpu.data.dataset import prepare_dataset as j_prepare
from mural_tpu.genome.tracks import TrackSet as JTrackSet
from mural_tpu.genome.tracks import read_track_list as j_read_track_list
from mural_tpu_torch.data import cache
from mural_tpu_torch.data.dataset import prepare_dataset
from mural_tpu_torch.genome.fasta import Genome
from mural_tpu_torch.genome.tracks import TrackSet
from test_torch_port_tracks import write_genome, write_tracks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = ["chrom_id", "start", "stop", "strand_neg", "y", "local1", "cat",
          "cont", "seg_offsets"]
# (central_bp, local_radius, local_order, distal_radius, model_type)
ARGS = (5000, 3, 2, 100, "snv")
CHROMS = {"chr1": 30_000, "chr2": 9_000}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_cache")
    rng = np.random.default_rng(5)
    fasta, bed = write_genome(base, rng, CHROMS, 600)
    return base, fasta, bed, write_tracks(base, rng, CHROMS)


def _tracks(track_list):
    """The same track list as each package's TrackSet."""
    files, names, radii = j_read_track_list(track_list, ARGS[1])
    return TrackSet(files, names, radii), JTrackSet(files, names, radii)


def _same_dataset(got, want):
    """Every cached array equal, dtype included; the chromosome table too."""
    assert got.chrom_names == want.chrom_names
    assert got.model_type == want.model_type
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(got.chrom_codes, want.chrom_codes):
        np.testing.assert_array_equal(a, b)


def _lines():
    out = []
    return out, lambda *a: out.append(" ".join(map(str, a)))


@pytest.mark.parametrize("with_tracks", [False, True])
@pytest.mark.parametrize("cache_dir", [None, "elsewhere"])
def test_cache_path_matches_jax(data, with_tracks, cache_dir):
    base, _, bed, track_list = data
    ours, theirs = _tracks(track_list) if with_tracks else (None, None)
    cache_dir = cache_dir and str(base / cache_dir)
    for seq_only in (False, True):
        assert cache.cache_path(bed, *ARGS, cache_dir, tracks=ours,
                                seq_only=seq_only) == jcache.cache_path(
            bed, *ARGS, cache_dir, tracks=theirs, seq_only=seq_only)


@pytest.mark.parametrize("n_files", [1, 4])
def test_jax_cache_loads_in_port(data, tmp_path, n_files):
    _, fasta, bed, track_list = data
    ours, theirs = _tracks(track_list)
    j_ds = jcache.prepare_dataset_cached(
        bed, fasta, *ARGS, cache_dir=str(tmp_path), tracks=theirs,
        printer=lambda *a: None, n_files=n_files)
    path = cache.cache_path(bed, *ARGS, str(tmp_path), tracks=ours)
    assert os.path.exists(path)
    assert len(glob.glob(path + ".part*")) == (n_files if n_files > 1
                                               else 0)
    assert cache.is_cache_fresh(path, bed)
    want = prepare_dataset(bed, fasta, *ARGS[:-1], model_type="snv",
                           tracks=ours)
    _same_dataset(cache.load_dataset_cache(path, Genome.from_fasta(fasta),
                                           *ARGS[:-1]), want)
    lines, printer = _lines()
    got = cache.prepare_dataset_cached(
        bed, fasta, *ARGS, cache_dir=str(tmp_path), tracks=ours,
        printer=printer, bw_distal=True, n_files=n_files)
    assert lines == [f"using cached site encodings: {path}"]
    _same_dataset(got, want)
    assert got.distal_tracks is ours
    assert j_ds.n_sites == got.n_sites


@pytest.mark.parametrize("n_files", [1, 4])
def test_port_cache_loads_in_jax(data, tmp_path, n_files):
    _, fasta, bed, track_list = data
    ours, theirs = _tracks(track_list)
    lines, printer = _lines()
    ds = cache.prepare_dataset_cached(bed, fasta, *ARGS,
                                      cache_dir=str(tmp_path), tracks=ours,
                                      printer=printer, n_files=n_files)
    path = cache.cache_path(bed, *ARGS, str(tmp_path), tracks=ours)
    assert lines == [f"wrote site-encoding cache ({n_files} file(s)): "
                     f"{path}"]
    _same_dataset(ds, prepare_dataset(bed, fasta, *ARGS[:-1],
                                      model_type="snv", tracks=ours))
    assert jcache.is_cache_fresh(path, bed)
    from mural_tpu.genome.fasta import Genome as JGenome
    got = jcache.load_dataset_cache(path, JGenome.from_fasta(fasta),
                                    *ARGS[:-1])
    _same_dataset(got, j_prepare(bed, fasta, *ARGS[:-1], model_type="snv",
                                 tracks=theirs))
    # no temporary file is left
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(path)] + [os.path.basename(p) for p in
                                    glob.glob(path + ".part*")])


def test_staleness(data, tmp_path):
    base, fasta, bed_src, _ = data
    bed = str(tmp_path / "sites.bed")
    with open(bed_src) as src, open(bed, "w") as dst:
        dst.write(src.read())
    os.utime(bed, (1e9, 1e9))
    kw = dict(cache_dir=str(tmp_path), printer=lambda *a: None, n_files=3)
    ds = cache.prepare_dataset_cached(bed, fasta, *ARGS, **kw)
    path = cache.cache_path(bed, *ARGS, str(tmp_path))
    for fresh in (cache.is_cache_fresh, jcache.is_cache_fresh):
        assert fresh(path, bed) and fresh(path, bed, ds.n_sites)
        assert not fresh(path, bed, ds.n_sites + 1)
    # a BED newer than the cache
    os.utime(bed, None)
    assert not cache.is_cache_fresh(path, bed)
    assert not jcache.is_cache_fresh(path, bed)
    cache.prepare_dataset_cached(bed, fasta, *ARGS, **kw)
    assert cache.is_cache_fresh(path, bed)
    # a missing shard
    os.remove(sorted(glob.glob(path + ".part*"))[1])
    assert not cache.is_cache_fresh(path, bed)
    assert not jcache.is_cache_fresh(path, bed)
    lines, printer = _lines()
    cache.prepare_dataset_cached(bed, fasta, *ARGS, **dict(kw,
                                                           printer=printer))
    assert lines[0].startswith("wrote site-encoding cache (3 file(s)):")
    assert cache.is_cache_fresh(path, bed)


def test_unreadable_cache_is_stale_and_rebuilt(data, tmp_path):
    """A cache the port's reader refuses (here the JAX writer's file
    rewritten with the shuffle filter, which h5py reads) is stale for
    the port, which rebuilds it; a damaged file is stale for both."""
    import h5py
    _, fasta, bed, _ = data
    kw = dict(cache_dir=str(tmp_path), printer=lambda *a: None)
    jcache.prepare_dataset_cached(bed, fasta, *ARGS, **kw)
    path = cache.cache_path(bed, *ARGS, str(tmp_path))
    with h5py.File(path, "r") as hf:
        attrs = dict(hf.attrs)
        arrays = {name: hf[name][()] for name in hf}
    with h5py.File(path, "w") as hf:
        hf.attrs.update(attrs)
        for name, a in arrays.items():
            hf.create_dataset(name, data=a, shuffle=True,
                              compression="gzip")
    assert jcache.is_cache_fresh(path, bed)
    assert not cache.is_cache_fresh(path, bed)
    lines, printer = _lines()
    ds = cache.prepare_dataset_cached(bed, fasta, *ARGS,
                                      **dict(kw, printer=printer))
    assert lines == [f"wrote site-encoding cache (1 file(s)): {path}"]
    assert cache.is_cache_fresh(path, bed)
    _same_dataset(ds, prepare_dataset(bed, fasta, *ARGS[:-1],
                                      model_type="snv"))
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 3)
    assert not cache.is_cache_fresh(path, bed)
    assert not jcache.is_cache_fresh(path, bed)


def test_concurrent_writers_threads(data, tmp_path):
    """Two threads writing one cache (single-file and 2 shards at once):
    each file goes through its own temporary name, so the cache left is
    fresh, loads and equals the dataset."""
    _, fasta, bed, _ = data
    ds = prepare_dataset(bed, fasta, *ARGS[:-1], model_type="snv")
    path = cache.cache_path(bed, *ARGS, str(tmp_path))
    errors = []

    def write(n_files):
        try:
            for _ in range(3):
                cache.save_dataset_cache(ds, path, n_files)
        except Exception as e:              # reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=write, args=(n,)) for n in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert errors == []
    assert cache.is_cache_fresh(path, bed)
    _same_dataset(cache.load_dataset_cache(path, Genome.from_fasta(fasta),
                                           *ARGS[:-1]), ds)
    assert not glob.glob(str(tmp_path / "*.tmp*"))


def test_concurrent_writers_processes(data, tmp_path):
    """Two processes running ``prepare_dataset_cached`` on one cache with
    4 shards, as the ranks of ``train --dp_devices 2`` do."""
    _, fasta, bed, _ = data
    script = textwrap.dedent(f"""
        import sys
        from mural_tpu_torch.data.cache import prepare_dataset_cached
        if __name__ == "__main__":
            for _ in range(2):
                ds = prepare_dataset_cached({bed!r}, {fasta!r}, *{ARGS!r},
                                            cache_dir={str(tmp_path)!r},
                                            n_files=4)
            print("SITES", ds.n_sites, "torch" in sys.modules)
    """)
    (tmp_path / "writer.py").write_text(script)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                  else [])))
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "writer.py")],
                              cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    want = prepare_dataset(bed, fasta, *ARGS[:-1], model_type="snv")
    # neither writer imported torch
    assert all(f"SITES {want.n_sites} False" in out for out, _ in outs)
    path = cache.cache_path(bed, *ARGS, str(tmp_path))
    assert cache.is_cache_fresh(path, bed)
    assert jcache.is_cache_fresh(path, bed)
    _same_dataset(cache.load_dataset_cache(path, Genome.from_fasta(fasta),
                                           *ARGS[:-1]), want)
    assert not glob.glob(str(tmp_path / "*.tmp*"))


def test_cache_module_imports_no_torch():
    """A spawned shard writer imports this module (and h5lite) only."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, mural_tpu_torch.data.cache; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'h5py', 'jax', 'mural_tpu')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
