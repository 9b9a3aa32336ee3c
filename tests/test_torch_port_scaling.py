"""The port's rate scaling (mural_tpu_torch.predict.scaling) against the
JAX package's (mural_tpu.predict.scaling), and the port's ``evaluate``,
``scale`` and ``calc_scaling_factor`` sub-commands against the JAX
package's on the same prediction TSVs: outputs byte-equal (decompressed
where gzip), factors within 1e-12, printed lines equal."""
import gzip
import os

import numpy as np
import pytest

import mural_tpu.evaluation.corr_files as jcf
import mural_tpu.predict.scaling as jsc
import mural_tpu_torch.predict.scaling as tsc
import mural_tpu_torch.utils.tsv as ttsv
from mural_tpu.cli.main import main as jax_main
from mural_tpu_torch.cli.main import main as port_main
from test_torch_port_corr_files import _write_genome, _write_pred

N_CLASS = 4


@pytest.fixture(scope="module")
def preds(tmp_path_factory):
    """Two prediction TSVs (plain and gzip) on chr2/chr10/chrUn; the
    second has a NaN probability (an empty field) in one row."""
    base = tmp_path_factory.mktemp("scaling")
    rng = np.random.default_rng(8)
    _write_genome(base / "seq.fa", rng)
    _write_pred(str(base / "a.tsv"), rng, n=2_400)
    _write_pred(str(base / "b.tsv"), rng, n=1_800)
    lines = (base / "b.tsv").read_text().split("\n")
    fields = lines[7].split("\t")
    fields[6] = ""
    lines[7] = "\t".join(fields)
    with gzip.open(base / "b.tsv.gz", "wt") as fh:
        fh.write("\n".join(lines))
    (base / "b.tsv").unlink()
    # overlapping and nested intervals, a chromosome without sites
    (base / "regions.bed").write_text(
        "chr2\t100\t900\nchr2\t500\t700\nchr2\t800\t1500\n"
        "chr10\t0\t50\nchr10\t2000\t3000\nchr10\t2500\t2600\n"
        "chrX\t0\t100\n")
    (base / "empty.bed").write_text("chrX\t0\t100\n")
    return base


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(ttsv, "CHUNK_ROWS", 500)


def _text(path):
    with ttsv.open_text(str(path)) as fh:
        return fh.read()


@pytest.mark.parametrize("src,out", [("a.tsv", "s.tsv"),
                                     ("b.tsv.gz", "s.tsv.gz")])
def test_apply_scaling(preds, small_chunks, src, out):
    files = []
    for name, mod in (("port", tsc), ("jax", jsc)):
        path = preds / f"{name}_{out}"
        mod.apply_scaling(str(preds / src), 1.37e-2, N_CLASS, str(path))
        files.append(_text(path))
    assert files[0] == files[1]
    rows = [r.split("\t") for r in files[0].splitlines()[1:]]
    if src == "b.tsv.gz":
        assert sum(r[6] == "" for r in rows) == 1
    sums = [sum(float(v) for v in r[5:] if v) for r in rows]
    assert max(abs(s - 1) for s in sums) <= 1e-3


@pytest.mark.parametrize("regions", [None, "regions.bed"])
def test_calc_mu_scaling_factor(preds, small_chunks, regions, tmp_path):
    pred_files = []
    for src in ("a.tsv", "b.tsv.gz"):
        os.symlink(preds / src, tmp_path / src)
        pred_files.append(str(tmp_path / src))
    out = {}
    for name, mod in (("port", tsc), ("jax", jsc)):
        lines = []
        factor = mod.calc_mu_scaling_factor(
            pred_files, 1.2e-8, [0.3, 0.7], N_CLASS, "snv",
            g_proportions=[0.4, 0.6],
            benchmark_regions=str(preds / regions) if regions else None,
            do_scaling=True,
            printer=lambda *a: lines.append(" ".join(map(str, a))))
        scaled = [_text(p + ".scaled.tsv.gz") for p in pred_files]
        out[name] = (factor, lines, scaled)
    (t_factor, t_lines, t_scaled), (j_factor, j_lines, j_scaled) = (
        out["port"], out["jax"])
    assert abs(t_factor - j_factor) <= 1e-12 * abs(j_factor)
    assert np.isfinite(t_factor) and t_factor > 0
    assert t_lines == j_lines and len(t_lines) == 14
    assert t_scaled == j_scaled


def test_regions_merge_and_zero_mass(preds):
    regions = tsc._load_regions(str(preds / "regions.bed"))
    j_regions = jsc._load_regions(str(preds / "regions.bed"))
    assert regions.keys() == j_regions.keys()
    for c in regions:
        np.testing.assert_array_equal(regions[c], j_regions[c])
    assert regions["chr2"].tolist() == [[100, 1500]]
    assert regions["chr10"].tolist() == [[0, 50], [2000, 3000]]
    starts = np.array([99, 100, 1499, 1500, 49, 50, 2999, 3000])
    chroms = np.array(["chr2"] * 4 + ["chr10"] * 4)
    hits = tsc._in_regions(chroms, starts, starts + 1, regions)
    assert hits.tolist() == [False, True, True, False, True, False, True,
                             False]
    np.testing.assert_array_equal(
        hits, jsc._in_regions(chroms, starts, starts + 1, j_regions))
    msgs = []
    for mod in (tsc, jsc):
        with pytest.raises(ValueError) as e:
            mod.calc_mu_scaling_factor(
                [str(preds / "a.tsv")], 1e-8, [1.0], N_CLASS,
                benchmark_regions=str(preds / "empty.bed"),
                printer=lambda *a: None)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "0 sites matched" in msgs[0]


def test_clis_write_the_same_files(preds, tmp_path, monkeypatch, capsys):
    """evaluate (k-mer and regional, then --kmer_only --kmer_length 5 and
    --regional_only), calc_scaling_factor --do_scaling and scale through
    each package's CLI, each in a directory of its own."""
    monkeypatch.setattr(jcf, "CHUNK_ROWS", 500)
    monkeypatch.setattr(ttsv, "CHUNK_ROWS", 500)
    fasta = str(preds / "seq.fa")
    outputs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        for src in ("a.tsv", "b.tsv.gz"):
            os.symlink(preds / src, work / src)
        runs = [
            ["evaluate", "--pred_file", "a.tsv", "--ref_genome", fasta,
             "--out_prefix", "ev"],
            ["evaluate", "--pred_file", "b.tsv.gz", "--ref_genome", fasta,
             "--out_prefix", "ev5", "--kmer_only", "--kmer_length", "5"],
            ["evaluate", "--pred_file", "b.tsv.gz", "--out_prefix", "evr",
             "--regional_only", "--window_size", "1000",
             "--ratio_cutoff", "0.5"],
            ["calc_scaling_factor", "--pred_files", "a.tsv", "b.tsv.gz",
             "--genomewide_mu", "1e-8", "--m_proportions", "0.5", "0.5",
             "--g_proportions", "0.5", "0.5", "--do_scaling"],
            ["scale", "--pred_file", "a.tsv", "b.tsv.gz", "--scale_factor",
             "0.01", "0.02", "--out_file", "sa.tsv", "sb.tsv.gz"],
        ]
        printed = []
        for argv in runs:
            assert main("snv", argv) == 0
            # the first line echoes the command line, which differs
            printed += capsys.readouterr().out.splitlines()[1:]
        outputs[name] = (printed, {f: _text(work / f)
                                   for f in sorted(os.listdir(work))
                                   if not os.path.islink(work / f)})
    (t_printed, t_files), (j_printed, j_files) = (outputs["port"],
                                                  outputs["jax"])
    assert sorted(t_files) == sorted(j_files) == sorted([
        "ev.3-mer.mut_rates.tsv", "ev.3-mer.corr.txt",
        "ev.100Kb.mut_rates.tsv", "ev.100Kb.corr.txt",
        "ev5.5-mer.mut_rates.tsv", "ev5.5-mer.corr.txt",
        "evr.1Kb.mut_rates.tsv", "evr.1Kb.corr.txt",
        "a.tsv.scaled.tsv.gz", "b.tsv.gz.scaled.tsv.gz", "sa.tsv",
        "sb.tsv.gz"])
    for f in t_files:
        assert t_files[f] == j_files[f], f
    assert t_printed == j_printed


def test_numeric_chromosome_benchmark_regions(tmp_path):
    """Sites and benchmark regions on a chromosome named '1': the port
    selects the site inside the region; the JAX package reads the name
    as an integer, matches no region and raises."""
    pred = tmp_path / "num.tsv"
    pred.write_text(
        "chrom\tstart\tend\tstrand\tmut_type\tprob0\tprob1\tprob2\tprob3\n"
        "1\t10\t11\t+\t0\t0.9\t0.05\t0.03\t0.02\n"
        "2\t10\t11\t+\t0\t0.8\t0.1\t0.06\t0.04\n")
    (tmp_path / "r.bed").write_text("1\t0\t100\n")
    kw = dict(benchmark_regions=str(tmp_path / "r.bed"),
              printer=lambda *a: None)
    factor = tsc.calc_mu_scaling_factor([str(pred)], 1e-8, [1.0], N_CLASS,
                                        **kw)
    assert factor == pytest.approx(1e-8 / 0.1, rel=1e-12)
    with pytest.raises(ValueError, match="0 sites matched"):
        jsc.calc_mu_scaling_factor([str(pred)], 1e-8, [1.0], N_CLASS, **kw)
