"""The port's native host loops (mural_tpu_torch.native, its own copy of
``encoder.cpp``) against mural_tpu.native and against the port's plain
versions (the numpy encoders, the numpy track means, the Python ``%.4g``
row formatter): exact, windows running off either end, zero sites, a
chromosome named ``1``; the data layer's outputs on the native loops
equal to the numpy path's; a failed build raises with the compiler's
errors, and concurrent builds of one library all load it."""
import threading

import numpy as np
import pytest

from mural_tpu import native as jnative
from mural_tpu_torch import native
from mural_tpu_torch.data.dataset import prepare_dataset
from mural_tpu_torch.genome import encode as enc
from mural_tpu_torch.genome.fasta import COMPLEMENT, decode_sequence
from mural_tpu_torch.genome.tracks import PrefixTrack


@pytest.fixture(scope="module")
def jax_lib():
    """mural_tpu's library, built (it falls back to numpy silently when
    it cannot be, which would make the comparison vacuous)."""
    assert jnative.available()


# (chromosome length, window width, number of sites)
GATHER_CASES = [(1000, 41, 300), (30, 401, 50), (5000, 8000, 7),
                (500, 1, 20), (500, 41, 0)]


@pytest.mark.parametrize("n,width,n_sites", GATHER_CASES)
def test_gather_windows(jax_lib, n, width, n_sites):
    rng = np.random.default_rng(n + width)
    codes = rng.integers(0, 15, n).astype(np.uint8)
    # starts before 0, inside, and running past the end
    starts = rng.integers(-width - 5, n + 5, n_sites)
    neg = rng.random(n_sites) < 0.5
    got = native.gather_windows(codes, starts, width, neg)
    assert got.shape == (n_sites, width) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, enc.gather_windows(codes, starts,
                                                          width, neg))
    np.testing.assert_array_equal(got, jnative.gather_windows(
        codes, starts, width, neg))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("n_sites", [0, 200])
def test_kmer_pack(jax_lib, k, n_sites):
    rng = np.random.default_rng(k)
    windows = rng.integers(0, 15, (n_sites, 15)).astype(np.uint8)
    windows[:, 3:10] = rng.integers(0, 4, (n_sites, 7))   # fewer pads
    got = native.kmer_pack(windows, k)
    assert got.shape == (n_sites, 16 - k) and got.dtype == np.int32
    np.testing.assert_array_equal(got, enc.kmer_ids(windows, k))
    np.testing.assert_array_equal(got, jnative.kmer_pack(windows, k))
    with pytest.raises(ValueError, match="kmer_pack: k=16"):
        native.kmer_pack(windows, 16)


def test_track_mean(jax_lib):
    rng = np.random.default_rng(5)
    # a chromosome of two and a half blocks, one of exactly two, one of
    # a single base, and an empty one
    values = {"chr1": rng.normal(size=10_000) * 3,
              "1": rng.integers(0, 9, 8192).astype(np.float64),
              "chrM": np.asarray([2.5]), "chrE": np.zeros(0)}
    track = PrefixTrack.from_values(values)
    for chrom, vals in values.items():
        n = len(vals)
        starts = rng.integers(-50, n + 50, 400)
        stops = starts + rng.integers(-3, 300, 400)
        starts[:3], stops[:3] = [0, n - 1, -5], [n, n + 7, 0]
        bp, ib = track.chroms[chrom]
        got = track.mean_ranges(chrom, starts, stops)
        np.testing.assert_array_equal(
            got, track.mean_ranges_reference(chrom, starts, stops))
        np.testing.assert_array_equal(
            got, jnative.track_mean(bp, ib, starts, stops, 4096))
        assert got.dtype == np.float64
    assert native.track_mean(bp, ib, [], [], 4096).shape == (0,)
    with pytest.raises(ValueError, match="block sums"):
        native.track_mean(bp[:-1], np.zeros(4097, np.float32), [0], [1],
                          4096)


@pytest.mark.parametrize("chrom,n,n_class", [("chrX", 300, 4), ("1", 40, 8),
                                             ("chr2", 0, 4)])
def test_format_pred_tsv(jax_lib, chrom, n, n_class):
    rng = np.random.default_rng(n)
    pos = np.sort(rng.integers(0, 10 ** 9, n))
    neg = rng.random(n) < 0.5
    probs = rng.dirichlet([1.0] * n_class, size=n)
    if n:
        # magnitudes that take %g's exponent form, and Poisson-calibrated
        # negatives
        probs[0, :4] = [1e-12, 1 - 3e-12, -2.5e-7, 1e-300]
        pos[0] = 0
    got = native.format_pred_tsv(chrom, pos, neg, probs)
    assert got == jnative.format_pred_tsv(chrom, pos, neg, probs)
    assert got == native.format_pred_tsv_reference(chrom, pos, neg, probs)
    lines = got.decode().splitlines()
    assert len(lines) == n
    if n:
        first = lines[0].split("\t")
        assert first[:5] == [chrom, "0", "1", "-" if neg[0] else "+", "0"]
        assert first[5:9] == ["1e-12", "1", "-2.5e-07", "1e-300"]


def test_dataset_on_native_loops_equals_numpy(tmp_path):
    """prepare_dataset's k-mer ids and gather_distal's windows, now on the
    native loops, equal the numpy path's."""
    rng = np.random.default_rng(3)
    fasta, bed = tmp_path / "g.fa", tmp_path / "s.bed"
    codes = rng.integers(0, 15, 3000).astype(np.uint8)
    fasta.write_text(f">chr1\n{decode_sequence(codes)}\n")
    rows = sorted((int(p), "+" if c == 0 else "-")
                  for p, c in enumerate(codes) if c in (0, 3))[::7]
    bed.write_text("".join(f"chr1\t{p}\t{p + 1}\t.\t0\t{s}\n"
                           for p, s in rows))
    ds = prepare_dataset(str(bed), str(fasta), central_bp=1000,
                         local_radius=4, local_order=3, distal_radius=60)
    lw = enc.window_size(4, 1, "snv")
    local = enc.gather_windows(codes, enc.expanded_start(ds.start, 4), lw,
                               ds.strand_neg)
    np.testing.assert_array_equal(ds.cat, enc.kmer_ids(local, 3))
    rows_idx = np.arange(ds.n_sites)[::-1]
    np.testing.assert_array_equal(
        ds.gather_distal(rows_idx),
        enc.gather_windows(codes, enc.expanded_start(ds.start[rows_idx],
                                                     60),
                           ds.distal_width, ds.strand_neg[rows_idx]))


def test_failed_build_raises_with_compiler_errors(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    lib = native.NativeLibrary(bad, tmp_path / "out" / "libbad.so")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed on .*bad\.cpp"
                       r"(.|\n)*error"):
        lib.load()
    assert list((tmp_path / "out").iterdir()) == []


def test_concurrent_builds(tmp_path):
    """Builds that race on one library path each compile to a name of
    their own and rename it into place: every one loads a whole
    library."""
    so = tmp_path / "libmural_encoder.so"
    libs = [native.NativeLibrary(native.SOURCE, so) for _ in range(4)]
    errors = []

    def build(lib):
        try:
            lib.load()
        except Exception as e:      # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert [p.name for p in tmp_path.iterdir()] == [so.name]
    out = np.empty((1, 3), np.uint8)
    for lib in libs:
        lib.load().mural_gather_windows(
            np.arange(5, dtype=np.uint8), 5, np.asarray([1]), 1, 3,
            np.zeros(1, np.uint8), COMPLEMENT, 14, out)
        np.testing.assert_array_equal(out, [[1, 2, 3]])
