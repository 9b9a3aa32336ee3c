"""The port's genome-wide predict (mural_tpu_torch.predict.genome_wide
and ``predict_genome`` of both CLIs) against the JAX package's on the
CPU: the sites of ``iter_focal_sites``, and the TSVs of one
mural_tpu-written SNVNet2 triple (fused, unfused, ``--poisson_calib``)
and one INDEL U-Net triple (``focal_base='all'``), with a ``chunk_size``
that cuts a chromosome into several device chunks; the port's rows
against its own BED predict of the same sites; the CLI against the
function; the errors.

Tolerances: rows and columns 0-4 equal; probabilities within 1.1e-3
relative, one unit in the 4th significant digit of ``%.4g`` (the two
packages' float32 forwards differ in their last bits, ROADMAP section 3).
"""
import gzip
import pickle

import numpy as np
import pytest

from mural_tpu.calibrate.dirichlet import FullDirichletCalibrator
from mural_tpu.data.dataset import prepare_dataset
from mural_tpu.genome.fasta import Genome as JGenome
from mural_tpu.genome.fasta import decode_sequence
from mural_tpu.predict.genome_wide import GenomePredictOptions as JOptions
from mural_tpu.predict.genome_wide import iter_focal_sites as j_sites
from mural_tpu.predict.genome_wide import run_genome_predict as j_run
from mural_tpu.predict.pipeline import build_model_from_config
from mural_tpu.train.checkpoint import save_checkpoint
from mural_tpu.train.loop import _init_variables
from mural_tpu_torch.cli.mural_indel import main as port_indel_cli
from mural_tpu_torch.cli.mural_snv import main as port_snv_cli
from mural_tpu_torch.genome.fasta import Genome
from mural_tpu_torch.predict import PredictOptions, run_predict
from mural_tpu_torch.predict.genome_wide import (GenomePredictOptions,
                                                 iter_focal_sites,
                                                 run_genome_predict)
from test_torch_port_indel_model import (_nontrivial,  # noqa: F401
                                          one_torch_thread)

SNV_CONFIG = dict(
    model_no=2, n_class=4, local_radius=3, local_order=2,
    local_hidden1_size=24, local_hidden2_size=12, emb_dropout=0.1,
    local_dropout=0.1, distal_fc_dropout=0.25, distal_radius=200,
    CNN_kernel_size=3, CNN_out_channels=8, segment_center=5000,
    distal_order=1, n_cont=0)
INDEL_CONFIG = dict(
    model_no=0, n_class=8, local_radius=6, local_order=1,
    distal_radius=100, CNN_kernel_size=7, CNN_out_channels=4,
    down_list=[1, 2, 2, 5, 5, 1], use_reverse=True, segment_center=4000,
    distal_order=1, n_cont=0)
# chr2 spans three chunks; '1' (a numeric name) is shorter than a chunk
CHROMS = (("chr2", 5000), ("1", 700))
CHUNK = 2048
REL = 1.1e-3
KEY = slice(0, 5)


def _write_genome(path, rng):
    with open(path, "w") as fh:
        for chrom, n in CHROMS:
            codes = rng.integers(0, 4, size=n).astype(np.uint8)
            codes[rng.integers(0, n, size=n // 50)] = 14          # N
            codes[rng.integers(0, n, size=n // 100)] = 4          # R
            fh.write(f">{chrom}\n{decode_sequence(codes)}\n")


def _write_bed(path, rows):
    """``rows`` of (chrom, pos, '+'/'-'), label 0."""
    with open(path, "w") as fh:
        for chrom, p, strand in rows:
            fh.write(f"{chrom}\t{p}\t{p + 1}\t.\t0\t{strand}\n")


def _calibrator(rng, n_class):
    logits = rng.normal(size=(400, n_class))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return FullDirichletCalibrator().fit(probs,
                                         rng.integers(0, n_class, 400))


def _jax_triple(base, name, config, bed, fasta, model_type, rng):
    ds = prepare_dataset(bed, fasta, central_bp=config["segment_center"],
                         local_radius=config["local_radius"],
                         local_order=config["local_order"],
                         distal_radius=config["distal_radius"],
                         model_type=model_type)
    vocab = 4 ** config["local_order"] + 1 if model_type == "snv" else 4
    dim = 2 if model_type == "snv" else 1
    config = dict(config, emb_dims=[(vocab, dim)] * ds.cat.shape[1])
    v = _init_variables(build_model_from_config(config, 0, model_type),
                        ds, 0)
    path = str(base / name / "model")
    save_checkpoint(path, _nontrivial(v["params"], rng),
                    _nontrivial(v["batch_stats"], rng), config,
                    calibrator=_calibrator(rng, config["n_class"]))
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_genome_wide")
    rng = np.random.default_rng(21)
    fasta = str(base / "seq.fa")
    _write_genome(fasta, rng)
    g = Genome.from_fasta(fasta)
    rows = []
    for chrom, _ in CHROMS:
        codes = g[chrom]
        for code, strand in ((0, "+"), (3, "-")):
            rows += [(chrom, int(p), strand) for p in rng.choice(
                np.flatnonzero(codes == code), 20, replace=False)]
    rows.sort(key=lambda r: (r[0], r[1]))
    bed = str(base / "sites.bed")
    _write_bed(bed, rows)
    return dict(base=base, fasta=fasta, bed=bed, genome=g, triples={
        "snv": _jax_triple(base, "snv", SNV_CONFIG, bed, fasta, "snv", rng),
        "indel": _jax_triple(base, "indel", INDEL_CONFIG, bed, fasta,
                             "indel", rng)})


def _read(path):
    with gzip.open(path, "rt") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh]
    return header, [r[KEY] for r in rows], np.asarray(
        [[float(v) for v in r[5:]] for r in rows])


def _assert_close(a, b):
    """Headers and columns 0-4 equal, probabilities within REL."""
    assert a[0] == b[0]
    assert a[1] == b[1]
    assert a[2].shape == b[2].shape
    assert np.all(np.abs(a[2] - b[2])
                  <= REL * np.maximum(np.abs(a[2]), np.abs(b[2]))), \
        np.abs(a[2] - b[2]).max()


def _opts(cls, inputs, model_type, out, **kw):
    path = inputs["triples"][model_type]
    return cls(ref_genome=inputs["fasta"], model_path=path,
               model_config_path=path + ".config.pkl",
               calibrator_path=path + ".fdiri_cal.pkl", pred_file=out,
               chunk_size=CHUNK, n_workers=0, **kw)


@pytest.mark.parametrize("focal_base", ["A", "C", "all"])
def test_iter_focal_sites_matches_jax(inputs, focal_base):
    jg = JGenome.from_fasta(inputs["fasta"])
    got = list(iter_focal_sites(inputs["genome"], focal_base, chunk=1500))
    want = list(j_sites(jg, focal_base, chunk=1500))
    assert len(got) == len(want) == 5      # chr2 in 4 chunks, '1' in 1
    for (c1, p1, n1), (c2, p2, n2) in zip(got, want):
        assert c1 == c2
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(n1, n2)
        assert p1.dtype == np.int64 and n1.dtype == bool


# (model type, focal base, batch size, fused, poisson)
CASES = {
    "snv2_fused": ("snv", "A", 256, True, False),
    "snv2_unfused": ("snv", "A", 256, False, False),
    "snv2_poisson": ("snv", "A", 256, False, True),
    "indel": ("indel", "all", 512, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_genome_predict_matches_jax(inputs, case):
    model_type, focal, batch, fused, poisson = CASES[case]
    base = inputs["base"]
    kw = dict(focal_base=focal, batch_size=batch, fused_inference=fused,
              poisson_calib=poisson, flush_batches=3)
    j_lines, t_lines = [], []
    n_jax = j_run(_opts(JOptions, inputs, model_type,
                        str(base / f"jax_{case}.tsv.gz"), **kw),
                  model_type, printer=lambda *a: j_lines.append(a))
    n_port = run_genome_predict(
        _opts(GenomePredictOptions, inputs, model_type,
              str(base / f"port_{case}.tsv.gz"), device="cpu",
              time_view=True, **kw),
        model_type, printer=lambda *a: t_lines.append(" ".join(map(str,
                                                                  a))))
    want = _read(base / f"jax_{case}.tsv.gz")
    got = _read(base / f"port_{case}.tsv.gz")
    _assert_close(got, want)
    expect = sum(len(p) for _, p, _ in iter_focal_sites(inputs["genome"],
                                                         focal))
    assert n_port == n_jax == len(got[1]) == expect
    assert {r[4] for r in got[1]} == {"0"}
    # every chromosome, in FASTA order
    assert list(dict.fromkeys(r[0] for r in got[1])) == ["chr2", "1"]
    assert t_lines[0] == "predict_genome phase timing:"
    # the span recorder's totals, a row a stage (inline farm)
    assert [line[2:34].strip() for line in t_lines[1:-1]] == [
        "load genome", "load checkpoint", "farm start", "feed", "issue",
        "flush", "flush: drain-queue wait", "card wait (drain thread)",
        "farm submit (drain thread)", "farm submit: inline postprocess",
        "farm close", "rows written"]
    assert t_lines[-2].split()[2] == f"{expect:,}"
    assert t_lines[-1].startswith(f"genome-wide predict: {expect:,} sites")


def test_genome_rows_match_bed_predict(inputs):
    """The genome-wide rows of chr2 (windows on the card's gather path,
    chunk edges included) against the port's own BED predict of those
    sites (the host gather)."""
    base = inputs["base"]
    out = str(base / "gw.tsv.gz")
    run_genome_predict(_opts(GenomePredictOptions, inputs, "snv", out,
                             device="cpu", batch_size=128,
                             fused_inference=True, chroms=["chr2"]),
                       "snv", printer=lambda *a: None)
    header, keys, probs = _read(out)
    bed = str(base / "gw.bed")
    _write_bed(bed, [(k[0], int(k[1]), k[3]) for k in keys])
    path = inputs["triples"]["snv"]
    cols = run_predict(PredictOptions(
        test_data=bed, ref_genome=inputs["fasta"], model_path=path,
        model_config_path=path + ".config.pkl",
        calibrator_path=path + ".fdiri_cal.pkl", pred_file="",
        pred_batch_size=128, fused_inference=True, device="cpu"),
        "snv", printer=lambda *a: None)
    assert [int(k[1]) for k in keys] == cols["start"].tolist()
    assert [k[3] for k in keys] == cols["strand"].tolist()
    bed_probs = np.stack([cols[f"prob{i}"] for i in range(4)], 1)
    # BED predict's probabilities are unrounded
    assert np.all(np.abs(probs - bed_probs) <= 5.1e-4 * np.abs(bed_probs))


@pytest.mark.parametrize("model_type", ["snv", "indel"])
def test_cli_matches_function(inputs, model_type, capsys):
    """``predict_genome --cpu_only`` with two farm workers writes the
    bytes of the function's inline run."""
    base, path = inputs["base"], inputs["triples"][model_type]
    fn_out = str(base / f"fn_{model_type}.tsv.gz")
    # the CLI's --focal_base default: A for SNV, all for INDEL
    run_genome_predict(_opts(GenomePredictOptions, inputs, model_type,
                             fn_out, device="cpu", batch_size=512,
                             chroms=["1"],
                             focal_base="A" if model_type == "snv"
                             else "all"),
                       model_type, printer=lambda *a: None)
    cli_out = str(base / f"cli_{model_type}.tsv.gz")
    cli = port_snv_cli if model_type == "snv" else port_indel_cli
    assert cli(["predict_genome", "--cpu_only", "--ref_genome",
                inputs["fasta"], "--model_path", path,
                "--model_config_path", path + ".config.pkl",
                "--calibrator_path", path + ".fdiri_cal.pkl",
                "--pred_file", cli_out, "--chroms", "1",
                "--pred_batch_size", "512", "--n_workers", "2",
                "--pred_time_view"]) == 0
    printed = capsys.readouterr().out
    assert "(2 postprocess workers)" in printed
    with gzip.open(fn_out, "rb") as a, gzip.open(cli_out, "rb") as b:
        assert a.read() == b.read()


def test_errors(inputs, tmp_path, monkeypatch):
    import torch
    path = inputs["triples"]["snv"]
    opts = _opts(GenomePredictOptions, inputs, "snv",
                 str(tmp_path / "o.tsv.gz"), device="cpu")
    # --n_devices 2 runs now: two CPU replicas write the rows of one
    run_genome_predict(opts, "snv", printer=lambda *a: None)
    two = str(tmp_path / "o2.tsv.gz")
    run_genome_predict(GenomePredictOptions(
        **{**opts.__dict__, "n_devices": 2, "pred_file": two}), "snv",
        printer=lambda *a: None)
    _assert_close(_read(two), _read(opts.pred_file))
    with open(path + ".config.pkl", "rb") as fh:
        config = pickle.load(fh)
    cont_config = str(tmp_path / "cont.config.pkl")
    with open(cont_config, "wb") as fh:
        pickle.dump(dict(config, n_cont=2), fh)
    with pytest.raises(ValueError, match=r"n_cont=2\); genome-wide "
                       "prediction does not generate continuous"):
        run_genome_predict(GenomePredictOptions(
            **{**opts.__dict__, "model_config_path": cont_config}), "snv")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_genome_predict(GenomePredictOptions(
            **{**opts.__dict__, "device": None}), "snv")
