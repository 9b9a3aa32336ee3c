"""The port's ``evaluate`` pipelines (mural_tpu_torch.evaluation.corr_files)
against the JAX package's (mural_tpu.evaluation.corr_files) on one shared
prediction TSV and FASTA, plain and gzip, in chunks small enough that
every run crosses chunk boundaries: every output file byte-equal, the
returned correlations and the printed lines equal."""
import os

import numpy as np
import pytest

import mural_tpu.evaluation.corr_files as jcf
import mural_tpu_torch.evaluation.corr_files as tcf
import mural_tpu_torch.utils.tsv as ttsv
from mural_tpu.genome.fasta import decode_sequence

N_CLASS = 4
CHROMS = {"chr2": 6_000, "chr10": 4_000}


def _write_genome(path, rng, names=None):
    codes = {}
    with open(path, "w") as fh:
        for (chrom, n), name in zip(CHROMS.items(), names or CHROMS):
            c = rng.integers(0, 4, n).astype(np.uint8)
            c[rng.integers(0, n, n // 100)] = 14           # N
            codes[name] = c
            fh.write(f">{name}\n{decode_sequence(c)}\n")
    return codes


def _write_pred(path, rng, n=3_000, rename=None):
    """Sites on both chromosomes (some at their edges, some 2-3 bp long,
    some on a chromosome the FASTA lacks), in blocks that are sorted
    within and unsorted between; probabilities carry a k-mer signal."""
    chroms = np.asarray(list(CHROMS) + ["chrUn"])[
        rng.choice(3, n, p=[0.6, 0.38, 0.02])]
    size = np.asarray([CHROMS.get(c, 500) for c in chroms])
    start = (rng.random(n) * size).astype(np.int64)
    start[:4] = [0, 1, 5_998, 5_999]
    chroms[:4] = "chr2"
    end = start + np.where(rng.random(n) < 0.05, 3, 1)
    strand = np.where(rng.random(n) < 0.5, "+", "-")
    mut = rng.integers(0, N_CLASS, n)
    alpha = np.stack([np.full(n, 40.0)] + [1 + 3 * (start % 7) / 7] * 3, 1)
    probs = np.stack([rng.dirichlet(a) for a in alpha])
    rows = np.arange(n).reshape(6, -1)[rng.permutation(6)].ravel()
    with ttsv.open_text(path, "wt") as fh:
        fh.write("chrom\tstart\tend\tstrand\tmut_type\t"
                 + "\t".join(f"prob{i}" for i in range(N_CLASS)) + "\n")
        for i in rows:
            name = rename.get(chroms[i], chroms[i]) if rename else chroms[i]
            fh.write(f"{name}\t{start[i]}\t{end[i]}\t{strand[i]}\t{mut[i]}\t"
                     + "\t".join("%.4g" % p for p in probs[i]) + "\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    base = tmp_path_factory.mktemp("corr_files")
    rng = np.random.default_rng(21)
    _write_genome(base / "seq.fa", rng)
    state = rng.bit_generator.state
    for name in ("pred.tsv", "pred.tsv.gz"):
        rng.bit_generator.state = state
        _write_pred(str(base / name), rng)
    return base


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(jcf, "CHUNK_ROWS", 700)
    monkeypatch.setattr(ttsv, "CHUNK_ROWS", 700)


def _run_both(fn_name, base, tag, *args, **kw):
    """Run ``fn_name`` of both packages with output prefixes
    ``<base>/<tag>.{port,jax}``; returns the two results, printed lines
    and files ({suffix: bytes}) of each, keyed "port" and "jax"."""
    out = {}
    for name, mod in (("port", tcf), ("jax", jcf)):
        lines = []
        prefix = str(base / f"{tag}.{name}")
        res = getattr(mod, fn_name)(*[prefix if a is _PREFIX else a
                                      for a in args],
                                    printer=lambda *a: lines.append(
                                        " ".join(map(str, a))), **kw)
        files = {f[len(os.path.basename(prefix)):]:
                 (base / f).read_bytes() for f in os.listdir(base)
                 if f.startswith(os.path.basename(prefix) + ".")}
        out[name] = (res, lines, files)
    return out


_PREFIX = object()


def _assert_equal_runs(out, n_files=2):
    (t_res, t_lines, t_files), (j_res, j_lines, j_files) = (out["port"],
                                                            out["jax"])
    assert t_res.keys() == j_res.keys() == set(range(1, N_CLASS))
    for i in t_res:
        np.testing.assert_array_equal(t_res[i], j_res[i])
        assert np.isfinite(t_res[i]).all()
    assert t_lines == j_lines and len(t_lines) == N_CLASS - 1
    assert t_files.keys() == j_files.keys() and len(t_files) == n_files
    for suffix in t_files:
        assert t_files[suffix] == j_files[suffix], suffix


@pytest.mark.parametrize("pred", ["pred.tsv", "pred.tsv.gz"])
@pytest.mark.parametrize("k", [3, 5])
def test_kmer_corr_snv(inputs, small_chunks, pred, k):
    out = _run_both("run_kmer_corr", inputs, f"kmer{k}{pred}",
                    str(inputs / pred), str(inputs / "seq.fa"), _PREFIX, k,
                    N_CLASS, "snv")
    _assert_equal_runs(out)
    header = out["port"][2][f".{k}-mer.mut_rates.tsv"].split(b"\n")[0]
    assert header.split(b"\t") == [
        b"type", b"avg_obs_rate1", b"avg_obs_rate2", b"avg_obs_rate3",
        b"avg_pred_rate1", b"avg_pred_rate2", b"avg_pred_rate3",
        b"number_of_mut1", b"number_of_mut2", b"number_of_mut3",
        b"number_of_all"]


@pytest.mark.parametrize("k,strand", [(2, None), (4, "both"), (4, "-")])
def test_kmer_corr_indel_even_k(inputs, small_chunks, k, strand):
    out = _run_both("run_kmer_corr", inputs, f"indel{k}{strand}",
                    str(inputs / "pred.tsv.gz"), str(inputs / "seq.fa"),
                    _PREFIX, k, N_CLASS, "indel", strand_override=strand)
    _assert_equal_runs(out)


@pytest.mark.parametrize("pred", ["pred.tsv", "pred.tsv.gz"])
@pytest.mark.parametrize("window", [500, 1_000])
def test_regional_corr(inputs, small_chunks, pred, window):
    """Windows keyed by (chrom, window_end) in first-seen order across
    chunks, the median filter, and the used/deprecated column."""
    out = _run_both("run_regional_corr", inputs, f"reg{window}{pred}",
                    str(inputs / pred), _PREFIX, window, 0.8, N_CLASS)
    _assert_equal_runs(out)
    rates = out["port"][2][f".{window // 1000}Kb.mut_rates.tsv"]
    assert b"\tdeprecated\n" in rates and b"\tused\n" in rates


@pytest.mark.parametrize("k,model_type,merge", [(3, "snv", True),
                                                (4, "indel", True),
                                                (3, "indel", False)])
def test_motif_corr(inputs, small_chunks, k, model_type, merge):
    out = _run_both("run_motif_corr", inputs, f"motif{k}{model_type}{merge}",
                    str(inputs / "pred.tsv.gz"), str(inputs / "seq.fa"),
                    _PREFIX, k, N_CLASS, model_type, merge_reverse=merge)
    _assert_equal_runs(out)


def test_validation_errors(inputs, tmp_path):
    """The header and column-count checks raise the same ValueError, and
    so do the k-mer and motif length checks."""
    text = (inputs / "pred.tsv").read_text().split("\n")
    bad_header = tmp_path / "bad_header.tsv"
    bad_header.write_text("\n".join(["pos" + text[0][5:]] + text[1:]))
    for path, n_class in ((bad_header, N_CLASS), (inputs / "pred.tsv", 8)):
        msgs = []
        for mod in (tcf, jcf):
            with pytest.raises(ValueError) as e:
                mod.run_regional_corr(str(path), str(tmp_path / "x"),
                                      1000, 0.2, n_class,
                                      printer=lambda *a: None)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert msgs[0].startswith(("Invalid file header: ['pos', 'start'",
                                   "Column count mismatch. Expected 13"))
    calls = [("run_kmer_corr", 4, "snv"), ("run_kmer_corr", 1, "snv"),
             ("run_kmer_corr", 3, "indel"), ("run_motif_corr", 1, "indel"),
             ("run_motif_corr", 4, "snv")]
    for fn, k, model_type in calls:
        msgs = []
        for mod in (tcf, jcf):
            with pytest.raises(ValueError) as e:
                getattr(mod, fn)(str(inputs / "pred.tsv"),
                                 str(inputs / "seq.fa"), str(tmp_path / "y"),
                                 k, N_CLASS, model_type)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_numeric_chromosome_names(tmp_path):
    """A genome whose chromosomes are named '1' and '2' (Ensembl style),
    and sites on '1', '2' and '3': the port's evaluate gives the same
    correlations and files as for the same data named 'chr2', 'chr10'
    and 'chrUn'.  The JAX package reads the names as
    integers and skips every row (corr_files.py:36 with :72), so its
    k-mer correlation raises."""
    for tag, names in (("chr", None), ("num", ["1", "2"])):
        rng = np.random.default_rng(5)
        _write_genome(tmp_path / f"{tag}.fa", rng, names)
        _write_pred(str(tmp_path / f"{tag}.tsv"), rng,
                    rename=dict(zip(CHROMS, names), chrUn="3") if names
                    else None)
    res = {}
    for tag in ("chr", "num"):
        res[tag] = tcf.run_kmer_corr(str(tmp_path / f"{tag}.tsv"),
                                     str(tmp_path / f"{tag}.fa"),
                                     str(tmp_path / tag), 3, N_CLASS,
                                     printer=lambda *a: None)
    assert res["chr"] == res["num"]
    assert (tmp_path / "chr.3-mer.mut_rates.tsv").read_bytes() == \
        (tmp_path / "num.3-mer.mut_rates.tsv").read_bytes()
    with pytest.raises(ValueError, match="at least 2"):
        jcf.run_kmer_corr(str(tmp_path / "num.tsv"), str(tmp_path / "num.fa"),
                          str(tmp_path / "jax"), 3, N_CLASS,
                          printer=lambda *a: None)
