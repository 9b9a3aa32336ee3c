"""The port's track features (mural_tpu_torch.genome.tracks, the track
columns of data/dataset.py and data/batcher.py) against the JAX
package's on the CPU: the prefix-sum structures, means and per-base
windows exactly for ``.npz`` and dense inputs, within 1e-12 relative for
bedGraph text (the port parses it without pandas, whose float parser
may land one ulp away), the on-disk cache read across packages, and the
dataset's ``cont`` and distal track values and their batches exactly."""
import gzip
import sys

import numpy as np
import pytest

import mural_tpu.genome.tracks as JT
from mural_tpu.data.batcher import segment_pool_batches as j_batches
from mural_tpu.data.dataset import prepare_dataset as j_prepare_dataset
from mural_tpu.genome.fasta import decode_sequence
from mural_tpu_torch.data.batcher import segment_pool_batches
from mural_tpu_torch.data.dataset import prepare_dataset
from mural_tpu_torch.genome import tracks as T

BEDGRAPH_RTOL = 1e-12


def write_genome(base, rng, chroms, n_per_strand):
    """A FASTA and a sorted BED of SNV sites ('+' on A, '-' on T), labels
    0..3 in turn so every class is present."""
    fasta, bed = base / "seq.fa", base / "sites.bed"
    rows = []
    with open(fasta, "w") as fh:
        for chrom, n in chroms.items():
            codes = rng.integers(0, 4, size=n).astype(np.uint8)
            codes[rng.integers(0, n, size=n // 200)] = 14
            fh.write(f">{chrom}\n{decode_sequence(codes)}\n")
            k = max(n * n_per_strand // max(chroms.values()), 4)
            for strand, base_code in (("+", 0), ("-", 3)):
                pos = rng.choice(np.flatnonzero(codes == base_code), size=k,
                                 replace=False)
                rows += [(chrom, int(p), strand, i % 4)
                         for i, p in enumerate(pos)]
    rows.sort(key=lambda r: (r[0], r[1]))
    with open(bed, "w") as fh:
        for chrom, p, strand, label in rows:
            fh.write(f"{chrom}\t{p}\t{p + 1}\t.\t{label}\t{strand}\n")
    return str(fasta), str(bed)


def write_tracks(base, rng, chroms, step=100):
    """Two seeded tracks over ``chroms``: a bedGraph (gzipped, with a
    ``track`` line, comments and mixed separators; the last chromosome
    stops short of its end) and an ``.npz`` of dense values (one
    chromosome left out).  Returns the track list file: the bedGraph
    takes radius 5, the ``.npz`` the default."""
    names = list(chroms)
    bg = base / "cov.bedGraph.gz"
    with gzip.open(bg, "wt") as fh:
        fh.write("track type=bedGraph name=cov\n# a comment line\n")
        for chrom in names:
            n = chroms[chrom] if chrom != names[-1] else chroms[chrom] // 2
            pos = 0
            while pos < n:
                end = min(pos + int(rng.integers(1, 2 * step)), n)
                sep = " " if rng.random() < 0.2 else "\t"
                fh.write(sep.join([chrom, str(pos), str(end),
                                   f"{rng.normal(1.0, 0.5):.4f}"]) + "\n")
                pos = end + int(rng.integers(0, step // 4))
    npz = base / "meth.npz"
    np.savez(npz, **{c: rng.random(chroms[c]).astype(np.float32)
                     for c in names[:-1]})
    track_list = base / "tracks.txt"
    track_list.write_text(f"# path name radius\n{bg} cov 5\n{npz} meth\n")
    return str(track_list)


def _same_track(ours, theirs, exact=True):
    assert sorted(ours.chroms) == sorted(theirs.chroms)
    for c in ours.chroms:
        (bp, ib), (jbp, jib) = ours.chroms[c], theirs.chroms[c]
        assert len(ib) == len(jib)
        if exact:
            np.testing.assert_array_equal(bp, jbp)
            np.testing.assert_array_equal(np.asarray(ib), np.asarray(jib))
        else:
            np.testing.assert_allclose(bp, jbp, rtol=BEDGRAPH_RTOL, atol=0)


def _queries(rng, n, size=400):
    starts = rng.integers(-300, n + 300, size)
    return starts, starts + rng.integers(0, 5000, size)


def test_read_track_list_matches_jax(tmp_path):
    path = tmp_path / "list.txt"
    path.write_text("# comment\n\na.bedGraph cov 3\nb.npz meth\nc.bw\n")
    assert T.read_track_list(str(path), 7) == JT.read_track_list(
        str(path), 7)
    assert T.read_track_list(str(path), 7) == (
        ["a.bedGraph", "b.npz", "c.bw"], ["cov", "meth", "c.bw"], [3, 7, 7])
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    assert T.read_track_list(str(empty), 7) == ([], [], [])


def test_from_values_means_and_windows_match_jax():
    rng = np.random.default_rng(5)
    n = 3 * T._K + 77
    vals = rng.normal(size=n) * 10
    vals[rng.integers(0, n, 20)] = np.nan
    ours = T.PrefixTrack.from_values({"c": vals})
    theirs = JT.PrefixTrack.from_values({"c": vals})
    _same_track(ours, theirs)
    starts, stops = _queries(rng, n)
    np.testing.assert_array_equal(ours.mean_ranges("c", starts, stops),
                                  theirs.mean_ranges("c", starts, stops))
    np.testing.assert_array_equal(ours.mean_ranges("x", starts, stops),
                                  np.zeros(len(starts)))
    neg = rng.random(len(starts)) < 0.5
    win = ours.window_values("c", starts, 57, neg)
    np.testing.assert_array_equal(win, theirs.window_values("c", starts, 57,
                                                            neg))
    # per-base values within 1e-4 of the block's magnitude, reversed rows
    # for the negative strand, zeros outside the chromosome
    dense = np.nan_to_num(vals)
    for i in range(0, len(starts), 37):
        idx = starts[i] + np.arange(57)
        want = np.where((idx >= 0) & (idx < n),
                        dense[np.clip(idx, 0, n - 1)], 0.0)
        want = want[::-1] if neg[i] else want
        np.testing.assert_allclose(win[i], want, rtol=0,
                                   atol=1e-4 * np.abs(dense).mean() * 10)


def test_from_intervals_across_build_chunks_matches_jax(monkeypatch):
    """Intervals crossing block and build-chunk edges (the build chunk
    forced down to one block in both packages): the same structures as
    the JAX package's and the same sums as the dense path."""
    monkeypatch.setattr(T, "_BUILD_CHUNK", T._K)
    monkeypatch.setattr(JT, "_BUILD_CHUNK", JT._K)
    rng = np.random.default_rng(7)
    n = T._K * 5 + 123
    starts = np.sort(rng.integers(0, n - 1, 200))
    ends = np.minimum(starts + rng.integers(1, 3 * T._K, 200), n)
    vals = rng.normal(size=200)
    ours = T.PrefixTrack.from_intervals({"c": (starts, ends, vals)})
    _same_track(ours, JT.PrefixTrack.from_intervals(
        {"c": (starts, ends, vals)}))
    dense = np.zeros(n)
    for s, e, v in zip(starts, ends, vals):
        dense[s:e] += v
    q_lo, q_hi = _queries(rng, n)
    np.testing.assert_allclose(
        ours.mean_ranges("c", q_lo, q_hi),
        T.PrefixTrack.from_values({"c": dense}).mean_ranges("c", q_lo,
                                                            q_hi),
        rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("suffix", [".bedGraph", ".bedGraph.gz", ".npz"])
def test_load_matches_jax(tmp_path, suffix):
    """Text (plain and gzipped, with a track line, comments, spaces and
    tabs) and .npz inputs load to the JAX package's structures; each
    package reads the other's cache."""
    rng = np.random.default_rng(11)
    chroms = {"1": 9000, "chr10": 5000}
    path = tmp_path / f"t{suffix}"
    if suffix == ".npz":
        np.savez(path, **{c: rng.normal(size=n) for c, n in chroms.items()})
    else:
        lines = ["track type=bedGraph", "# comment"]
        for c, n in chroms.items():
            for s in range(0, n - 50, 60):
                lines.append(f"{c} {s}\t{s + int(rng.integers(1, 60))} "
                             f"{rng.normal():.6g}  # tail")
        text = "\n".join(lines) + "\n"
        if suffix.endswith(".gz"):
            with gzip.open(path, "wt") as fh:
                fh.write(text)
        else:
            path.write_text(text)
    exact = suffix == ".npz"
    ours = T.PrefixTrack.load(str(path))
    theirs = JT.PrefixTrack.load(str(path), cache_dir=str(tmp_path / "jc"))
    _same_track(ours, theirs, exact)
    assert "1" in ours.chroms           # chromosome names stay strings
    starts, stops = _queries(rng, 9000)
    np.testing.assert_allclose(ours.mean_ranges("1", starts, stops),
                               theirs.mean_ranges("1", starts, stops),
                               rtol=0 if exact else BEDGRAPH_RTOL, atol=0)
    if exact:
        return
    # the port's cache (<path>.mural_cache) loads in the JAX package, and
    # the JAX package's loads in the port: read-only memmaps (a rebuild
    # would write its own)
    from_port = JT.PrefixTrack.load(str(path))
    from_jax = T.PrefixTrack.load(str(path), cache_dir=str(tmp_path / "jc"))
    for a, b in ((from_port, ours), (from_jax, theirs)):
        assert all(isinstance(ib, np.memmap) and ib.mode == "r"
                   for _, ib in a.chroms.values())
        _same_track(a, b)


def test_bigwig_needs_pybigwig(tmp_path, monkeypatch):
    path = tmp_path / "t.bw"
    path.write_bytes(b"\0")
    monkeypatch.setitem(sys.modules, "pyBigWig", None)
    with pytest.raises(ImportError, match="pyBigWig"):
        T.PrefixTrack.load(str(path))
    with pytest.raises(ImportError, match="pyBigWig"):
        JT.PrefixTrack.load(str(path))


def test_missing_track_file_raises(tmp_path):
    track_list = tmp_path / "tracks.txt"
    track_list.write_text(f"{tmp_path / 'absent.bedGraph'} cov\n")
    files, names, radii = T.read_track_list(str(track_list), 7)
    with pytest.raises(FileNotFoundError):
        T.TrackSet(files, names, radii)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_tracks")
    rng = np.random.default_rng(13)
    chroms = {"1": 20_000, "chr2": 9_000}
    fasta, bed = write_genome(base, rng, chroms, 120)
    track_list = write_tracks(base, rng, chroms)
    files, names, radii = T.read_track_list(track_list, 3)
    return dict(fasta=fasta, bed=bed, files=files, names=names, radii=radii)


def _track_sets(genome, tmp_path):
    """The same list loaded by both packages, the bedGraph read through
    the JAX package's cache in both (so the values are bit-equal)."""
    theirs = JT.TrackSet(genome["files"], genome["names"], genome["radii"],
                         cache_dir=str(tmp_path / "cache"))
    ours = T.TrackSet(genome["files"], genome["names"], genome["radii"],
                      cache_dir=str(tmp_path / "cache"))
    return ours, theirs


def test_track_set_matches_jax(genome, tmp_path):
    ours, theirs = _track_sets(genome, tmp_path)
    rng = np.random.default_rng(17)
    chroms = np.asarray(["1", "chr2", "chrX"])[rng.integers(0, 3, 500)]
    starts = rng.integers(-10, 20_010, 500)
    args = (list(chroms), starts, starts + 1)
    for model_type in ("snv", "indel"):
        np.testing.assert_array_equal(
            ours.mean_over_sites(*args, model_type=model_type),
            theirs.mean_over_sites(*args, model_type=model_type))
    neg = rng.random(500) < 0.5
    np.testing.assert_array_equal(ours.distal_windows("1", starts, 41, neg),
                                  theirs.distal_windows("1", starts, 41,
                                                        neg))
    # a bedGraph parsed by each package: within an ulp's effect
    fresh = T.TrackSet(genome["files"], genome["names"], genome["radii"],
                       cache_dir=str(tmp_path / "port_cache"))
    np.testing.assert_allclose(fresh.mean_over_sites(*args),
                               theirs.mean_over_sites(*args),
                               rtol=BEDGRAPH_RTOL, atol=0)


@pytest.mark.parametrize("bw_distal,seq_only", [(False, False),
                                                (True, False),
                                                (True, True)])
def test_dataset_and_batches_match_jax(genome, tmp_path, bw_distal,
                                       seq_only):
    """``cont`` and the per-base distal track values of the dataset, its
    segment subsets and its batches (shuffled, and in order with the
    padded, zeroed last batch) equal the JAX package's."""
    ours, theirs = _track_sets(genome, tmp_path)
    kw = dict(central_bp=3000, local_radius=3, local_order=2,
              distal_radius=50, seq_only=seq_only, bw_distal=bw_distal)
    ds = prepare_dataset(genome["bed"], genome["fasta"], tracks=ours, **kw)
    jds = j_prepare_dataset(genome["bed"], genome["fasta"], tracks=theirs,
                            **kw)
    assert ds.n_cont == jds.n_cont == (0 if seq_only else 2)
    assert ds.n_distal_tracks == jds.n_distal_tracks == (
        2 if bw_distal and not seq_only else 0)
    if seq_only:
        assert ds.cont is None and ds.distal_tracks is None
    else:
        assert ds.cont.dtype == np.float32
        np.testing.assert_array_equal(ds.cont, jds.cont)
    segs = np.arange(0, ds.n_segments, 2)
    sub, jsub = ds.subset_segments(segs), jds.subset_segments(segs)
    if not seq_only:
        np.testing.assert_array_equal(sub.cont, jsub.cont)
    assert sub.n_distal_tracks == ds.n_distal_tracks
    for shuffle, pad in ((True, False), (False, True)):
        ours_b = list(segment_pool_batches(sub, 2, 48, shuffle=shuffle,
                                           rng=np.random.default_rng(3),
                                           pad_final=pad))
        theirs_b = list(j_batches(jsub, 2, 48, shuffle=shuffle,
                                  rng=np.random.default_rng(3),
                                  pad_final=pad))
        assert len(ours_b) == len(theirs_b) > 1
        for b, jb in zip(ours_b, theirs_b):
            np.testing.assert_array_equal(b.distal, jb.distal)
            for name in ("cont", "distal_tracks"):
                got, want = getattr(b, name), getattr(jb, name)
                assert (got is None) == (want is None)
                if got is not None:
                    assert got.dtype == np.float32
                    np.testing.assert_array_equal(got, want)
        last = ours_b[-1]
        if pad:
            assert last.n_valid < 48
            for arr in (last.cont, last.distal_tracks):
                if arr is not None:
                    assert not arr[last.n_valid:].any()
    if bw_distal and not seq_only:
        # reverse-strand rows come back reversed: against the forward
        # window of the same site
        rows = np.flatnonzero(ds.strand_neg)[:5]
        vals = ds.gather_distal_track_values(rows)
        starts = ds.start[rows] - ds.distal_radius
        for i, r in enumerate(rows):
            fwd = ours.distal_windows(ds.chrom_names[ds.chrom_id[r]],
                                      starts[i:i + 1], ds.distal_width)
            np.testing.assert_array_equal(vals[i], fwd[0, ::-1])
