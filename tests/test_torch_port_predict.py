"""The port's ``mural_snv predict`` (mural_tpu_torch.predict.run_predict
and its CLI) against the JAX package's on the CPU: one checkpoint triple
written by mural_tpu (msgpack weights + a fitted FullDirichlet
calibrator), predicted with and without --fused_inference, with the
inline k-mer and regional correlations."""
import gzip
import re

import numpy as np
import pandas as pd
import pytest

from mural_tpu.calibrate.dirichlet import FullDirichletCalibrator
from mural_tpu.data.dataset import prepare_dataset
from mural_tpu.genome.fasta import decode_sequence
from mural_tpu.predict import PredictOptions as JOptions
from mural_tpu.predict import run_predict as j_run_predict
from mural_tpu.predict.pipeline import build_model_from_config
from mural_tpu.train.checkpoint import save_checkpoint
from mural_tpu.train.loop import _init_variables
from mural_tpu_torch.cli.mural_snv import main as port_cli
from mural_tpu_torch.predict import PredictOptions, run_predict

CONFIG = dict(
    model_no=2, n_class=4, local_radius=3, local_order=2,
    local_hidden1_size=24, local_hidden2_size=12, emb_dropout=0.1,
    local_dropout=0.1, distal_fc_dropout=0.25, distal_radius=200,
    CNN_kernel_size=3, CNN_out_channels=8, segment_center=5000,
    distal_order=1, n_cont=0)


def _write_inputs(base, rng):
    """Two chromosomes (one shorter than a window) with N runs; '+' sites
    on A and '-' sites on T, as the mid-base check requires."""
    fasta, bed = base / "seq.fa", base / "sites.bed"
    rows = []
    with open(fasta, "w") as fh:
        for chrom, n in (("chr2", 30_000), ("chrM", 350)):
            codes = rng.integers(0, 4, size=n).astype(np.uint8)
            codes[rng.integers(0, n, size=n // 100)] = 14
            seq = decode_sequence(codes)
            fh.write(f">{chrom}\n{seq}\n")
            for strand, base_ch in (("+", "A"), ("-", "T")):
                pos = [i for i, c in enumerate(seq) if c == base_ch]
                for p in rng.choice(pos, size=min(60, len(pos) // 4),
                                    replace=False):
                    rows.append((chrom, int(p), strand,
                                 int(rng.integers(0, 4))))
    rows.sort(key=lambda r: (r[0], r[1]))
    with open(bed, "w") as fh:
        for chrom, p, strand, label in rows:
            fh.write(f"{chrom}\t{p}\t{p + 1}\t.\t{label}\t{strand}\n")
    return str(fasta), str(bed), len(rows)


def _nontrivial(tree, rng):
    return {k: _nontrivial(v, rng) if isinstance(v, dict) else
            (rng.uniform(0.5, 2.0, v.shape) if k in ("scale", "var") else
             rng.normal(0, 0.2, v.shape) if k in ("bias", "mean") else
             np.asarray(v)).astype(np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def triple(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_predict")
    rng = np.random.default_rng(11)
    fasta, bed, n_sites = _write_inputs(base, rng)
    ds = prepare_dataset(bed, fasta, central_bp=5000, local_radius=3,
                         local_order=2, distal_radius=200)
    config = dict(CONFIG, emb_dims=[(17, 2)] * ds.cat.shape[1])
    model = build_model_from_config(config, 0, "snv")
    v = _init_variables(model, ds, 0)
    params = _nontrivial(v["params"], rng)
    stats = _nontrivial(v["batch_stats"], rng)
    logits = rng.normal(size=(300, 4))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    cal = FullDirichletCalibrator().fit(probs, rng.integers(0, 4, 300))
    path = str(base / "checkpoint_0" / "model")
    save_checkpoint(path, params, stats, config, calibrator=cal)
    return dict(fasta=fasta, bed=bed, n_sites=n_sites, model=path,
                config=path + ".config.pkl",
                calibrator=path + ".fdiri_cal.pkl", base=base)


def _mean_loss(lines):
    line = next(m for m in lines if m.startswith("Mean Loss"))
    return float(line.split(":")[1].split()[0])


def _correlations(lines):
    """{'3mer' | '<w>bp': [r per class]} of predict's printed k-mer and
    regional correlation lines."""
    out = {}
    for line in lines:
        m = re.match(r"(\d+mer) correlation: +\[(.*)\]$", line) or \
            re.match(r"regional corr: (\d+bp) \[(.*)\]$", line)
        if m:
            out[m[1]] = [float(v) for v in m[2].split(",")]
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_predict_matches_jax(triple, fused, capsys):
    common = dict(test_data=triple["bed"], ref_genome=triple["fasta"],
                  model_path=triple["model"],
                  model_config_path=triple["config"],
                  calibrator_path=triple["calibrator"], pred_batch_size=32,
                  fused_inference=fused, kmer_corr=[3, 5],
                  region_corr=[1000])
    base = triple["base"]
    j_lines, t_lines = [], []
    j_run_predict(JOptions(pred_file=str(base / f"jax{fused}.tsv.gz"),
                           **common),
                  "snv", printer=lambda *a: j_lines.append(
                      " ".join(map(str, a))))
    out = run_predict(PredictOptions(
        pred_file=str(base / f"port{fused}.tsv.gz"), device="cpu",
        **common), "snv", printer=lambda *a: t_lines.append(
            " ".join(map(str, a))))
    cli_file = str(base / f"cli{fused}.tsv")
    argv = ["predict", "--cpu_only", "--ref_genome", triple["fasta"],
            "--test_data", triple["bed"], "--model_path", triple["model"],
            "--model_config_path", triple["config"], "--calibrator_path",
            triple["calibrator"], "--pred_batch_size", "32",
            "--pred_file", cli_file, "--kmer_corr", "3", "5",
            "--region_corr", "1000"] + (["--fused_inference"] if fused
                                        else [])
    assert port_cli(argv) == 0
    cli_lines = capsys.readouterr().out.splitlines()
    cli_loss = _mean_loss(cli_lines)

    jdf = pd.read_csv(base / f"jax{fused}.tsv.gz", sep="\t")
    prob_cols = [f"prob{i}" for i in range(4)]
    for path in (base / f"port{fused}.tsv.gz", cli_file):
        tdf = pd.read_csv(path, sep="\t")
        assert list(tdf.columns) == list(jdf.columns)
        assert len(tdf) == triple["n_sites"]
        key = ["chrom", "start", "end", "strand", "mut_type"]
        assert tdf[key].equals(jdf[key])
        np.testing.assert_allclose(tdf[prob_cols].to_numpy(),
                                   jdf[prob_cols].to_numpy(), rtol=1e-3,
                                   atol=0)
    np.testing.assert_allclose(
        np.stack([out[c] for c in prob_cols], 1).sum(1), 1, atol=1e-6)
    j_loss = _mean_loss(j_lines)
    # the correlations of the two packages' probabilities (1e-7 apart)
    j_corr = _correlations(j_lines)
    assert list(j_corr) == ["3mer", "5mer", "1000bp"]
    for lines in (t_lines, cli_lines):
        corr = _correlations(lines)
        assert list(corr) == list(j_corr)
        for name in corr:
            np.testing.assert_allclose(corr[name], j_corr[name], rtol=0,
                                       atol=1e-6)
            assert np.isfinite(corr[name]).all()
    assert abs(_mean_loss(t_lines) - j_loss) <= 1e-5 * abs(j_loss)
    assert abs(cli_loss - j_loss) <= 1e-5 * abs(j_loss)
    with gzip.open(base / f"port{fused}.tsv.gz", "rt") as fh:
        assert fh.readline().rstrip("\n").split("\t") == list(jdf.columns)


def test_predict_without_cpu_request_needs_cuda(triple, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = PredictOptions(test_data=triple["bed"],
                          ref_genome=triple["fasta"],
                          model_path=triple["model"],
                          model_config_path=triple["config"], pred_file="")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_predict(opts, "snv", printer=lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["predict", "--ref_genome", triple["fasta"],
                  "--test_data", triple["bed"], "--model_path",
                  triple["model"], "--model_config_path", triple["config"],
                  "--pred_file", ""])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["train", "--ref_genome", triple["fasta"],
                  "--train_data", triple["bed"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["transfer", "--ref_genome", triple["fasta"],
                  "--train_data", triple["bed"], "--model_path",
                  triple["model"], "--model_config_path", triple["config"]])
