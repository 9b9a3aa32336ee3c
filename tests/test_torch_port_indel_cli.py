"""``mural_indel`` through the port's CLI (``python -m
mural_tpu_torch.cli.mural_indel``) on the CPU, against the JAX package's:
train -> get_best_model -> predict; predict on one mural_tpu-written
INDEL triple (msgpack weights and a fitted FullDirichlet calibrator)
against mural_tpu's ``run_predict``; evaluate (even k and the motif
correlation), calc_scaling_factor and scale writing the same files as
the JAX package's CLI; and the entry points that need a card."""
import os

import numpy as np
import pandas as pd
import pytest

import mural_tpu.evaluation.corr_files as jcf
import mural_tpu_torch.utils.tsv as ttsv
from mural_tpu.calibrate.dirichlet import FullDirichletCalibrator
from mural_tpu.cli.main import main as jax_main
from mural_tpu.data.dataset import prepare_dataset
from mural_tpu.predict import PredictOptions as JOptions
from mural_tpu.predict import run_predict as j_run_predict
from mural_tpu.predict.pipeline import build_model_from_config
from mural_tpu.train.checkpoint import save_checkpoint
from mural_tpu.train.loop import _init_variables
from mural_tpu_torch.cli.main import main as port_main
from mural_tpu_torch.cli.mural_indel import main as port_cli
from test_torch_port_indel_model import (_nontrivial,  # noqa: F401
                                          one_torch_thread)
from test_torch_port_indel_train import write_indel_data

N_CLASS = 8
PROBS = [f"prob{i}" for i in range(N_CLASS)]
HEADER = ["chrom", "start", "end", "strand", "mut_type"] + PROBS
# small U-Net widths; the INDEL local columns of the CLI
CONFIG = dict(
    model_no=0, n_class=N_CLASS, local_radius=6, local_order=1,
    distal_radius=100, CNN_kernel_size=7, CNN_out_channels=4,
    down_list=[1, 2, 2, 5, 5, 1], use_reverse=True, segment_center=4000,
    distal_order=1, n_cont=0)
SMALL = ["--distal_radius", "100", "--down_list", "1", "2", "2", "5", "5",
         "1", "--CNN_out_channels", "4", "--batch_size", "32",
         "--segment_center", "4000", "--use_reverse"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_indel_cli")
    fasta, bed = write_indel_data(base, np.random.default_rng(7),
                                  n_sites=960)
    return base, fasta, bed


@pytest.fixture(scope="module")
def triple(data):
    """An INDEL checkpoint triple written by mural_tpu."""
    base, fasta, bed = data
    rng = np.random.default_rng(12)
    ds = prepare_dataset(bed, fasta, central_bp=4000, local_radius=6,
                         local_order=1, distal_radius=100,
                         model_type="indel")
    config = dict(CONFIG, emb_dims=[(4, 1)] * ds.cat.shape[1])
    v = _init_variables(build_model_from_config(config, 0, "indel"), ds, 0)
    logits = rng.normal(size=(600, N_CLASS))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    cal = FullDirichletCalibrator().fit(probs,
                                        rng.integers(0, N_CLASS, 600))
    path = str(base / "jax_triple" / "model")
    save_checkpoint(path, _nontrivial(v["params"], rng),
                    _nontrivial(v["batch_stats"], rng), config,
                    calibrator=cal)
    return path


def _mean_loss(lines):
    line = next(m for m in lines if m.startswith("Mean Loss"))
    return float(line.split(":")[1].split()[0])


def _predict_argv(fasta, bed, model, out, *extra):
    return ["predict", "--cpu_only", "--ref_genome", fasta, "--test_data",
            bed, "--model_path", model, "--model_config_path",
            model + ".config.pkl", "--calibrator_path",
            model + ".fdiri_cal.pkl", "--pred_batch_size", "64",
            "--pred_file", out, *extra]


def test_cli_train_get_best_model_predict(data, monkeypatch, capsys):
    base, fasta, bed = data
    monkeypatch.chdir(base)
    assert port_cli(["train", "--cpu_only", "--ref_genome", fasta,
                     "--train_data", bed, "--experiment_name", "cli",
                     "--n_trials", "1", "--epochs", "2", "--valid_ratio",
                     "0.5", "--split_seed", "0", *SMALL]) == 0
    (trial,) = [d for d in os.listdir(base / "results" / "cli")
                if d.startswith("Train_")]
    for epoch in (0, 1):
        ck = base / "results" / "cli" / trial / f"checkpoint_{epoch}"
        assert sorted(os.listdir(ck)) == [
            f"epoch_{epoch}_metrics.txt", "model", "model.config.pkl",
            "model.fdiri_cal.pkl"]
    progress = (base / "results" / "cli" / trial / "progress.csv"
                ).read_text().splitlines()
    assert len(progress) == 3
    assert all(np.isfinite(float(row.split(",")[4])) for row in progress[1:])
    log = (base / "results" / "cli" / trial / "training.log").read_text()
    # the INDEL epoch tail evaluates even k-mers
    assert all(f"{k}mer correlation - all:" in log for k in (2, 4, 6))
    capsys.readouterr()
    assert port_cli(["get_best_model", "--trial_path", "results/cli"]) == 0
    best, loss = capsys.readouterr().out.splitlines()[-1].split("\t")
    assert os.path.dirname(best).endswith(trial) and np.isfinite(float(loss))
    assert port_cli(_predict_argv(fasta, bed, f"{best}/model",
                                  "pred.tsv.gz")) == 0
    assert np.isfinite(_mean_loss(capsys.readouterr().out.splitlines()))
    df = pd.read_csv(base / "pred.tsv.gz", sep="\t")
    assert list(df.columns) == HEADER
    assert len(df) == sum(1 for _ in open(bed))
    # Poisson calibration (always on for INDEL) keeps each row's sum at 1
    # but not the signs; %.4g puts each value within 5e-4 of itself
    probs = df[PROBS].to_numpy()
    assert np.all(np.abs(probs.sum(1) - 1) <= 5e-4 * np.abs(probs).sum(1)
                  + 1e-9)


def test_predict_matches_jax_on_a_mural_tpu_triple(data, triple, capsys):
    """The same rows and labels, the eight probabilities within %.4g and
    Mean Loss within 1e-5 relative; --fused_inference on an INDEL model
    prints the JAX package's note and takes the standard path."""
    base, fasta, bed = data
    j_lines = []
    common = dict(test_data=bed, ref_genome=fasta, model_path=triple,
                  model_config_path=triple + ".config.pkl",
                  calibrator_path=triple + ".fdiri_cal.pkl",
                  pred_batch_size=64, fused_inference=True)
    j_run_predict(JOptions(pred_file=str(base / "jax.tsv.gz"), **common),
                  "indel", printer=lambda *a: j_lines.append(
                      " ".join(map(str, a))))
    capsys.readouterr()
    assert port_cli(_predict_argv(fasta, bed, triple, str(base / "port.tsv"),
                                  "--fused_inference")) == 0
    t_lines = capsys.readouterr().out.splitlines()
    note = [line for line in t_lines if line.startswith("NOTE")]
    assert note and note == [line for line in j_lines
                             if line.startswith("NOTE")]
    jdf = pd.read_csv(base / "jax.tsv.gz", sep="\t")
    tdf = pd.read_csv(base / "port.tsv", sep="\t")
    assert list(tdf.columns) == list(jdf.columns) == HEADER
    assert len(tdf) == 960
    key = ["chrom", "start", "end", "strand", "mut_type"]
    assert tdf[key].equals(jdf[key])
    # both files print %.4g: one unit in the 4th digit apart at most
    np.testing.assert_allclose(tdf[PROBS].to_numpy(), jdf[PROBS].to_numpy(),
                               rtol=1.1e-3, atol=0)
    j_loss = _mean_loss(j_lines)
    assert abs(_mean_loss(t_lines) - j_loss) <= 1e-5 * abs(j_loss)


def test_evaluate_and_scaling_clis_write_the_same_files(data, triple,
                                                        tmp_path,
                                                        monkeypatch, capsys):
    """evaluate (default even k-mers and regional, then --motif_only and
    --strand both), calc_scaling_factor --do_scaling and scale through
    each package's mural_indel CLI on one INDEL prediction TSV: the same
    files, byte for byte, and the same printed lines."""
    base, fasta, bed = data
    pred = tmp_path / "pred.tsv"
    assert port_cli(_predict_argv(fasta, bed, triple, str(pred))) == 0
    monkeypatch.setattr(jcf, "CHUNK_ROWS", 200)
    monkeypatch.setattr(ttsv, "CHUNK_ROWS", 200)
    capsys.readouterr()
    outputs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        os.symlink(pred, work / "pred.tsv")
        runs = [
            ["evaluate", "--pred_file", "pred.tsv", "--ref_genome", fasta,
             "--out_prefix", "ev", "--window_size", "5000"],
            ["evaluate", "--pred_file", "pred.tsv", "--ref_genome", fasta,
             "--out_prefix", "ev4", "--kmer_only", "--kmer_length", "4",
             "--strand", "both"],
            ["evaluate", "--pred_file", "pred.tsv", "--ref_genome", fasta,
             "--out_prefix", "motif", "--motif_only"],
            ["calc_scaling_factor", "--pred_files", "pred.tsv",
             "--genomewide_mu", "1e-9", "--m_proportions", "1",
             "--do_scaling"],
            ["scale", "--pred_file", "pred.tsv", "--scale_factor", "0.01",
             "--out_file", "s.tsv.gz"],
        ]
        printed = []
        for argv in runs:
            assert main("indel", argv) == 0
            # the first line echoes the command line, which differs
            printed += capsys.readouterr().out.splitlines()[1:]
        outputs[name] = (printed, {f: _text(work / f)
                                   for f in sorted(os.listdir(work))
                                   if not os.path.islink(work / f)})
    (t_printed, t_files), (j_printed, j_files) = (outputs["port"],
                                                  outputs["jax"])
    assert sorted(t_files) == sorted(j_files)
    assert {"ev.2-mer.corr.txt", "ev.5Kb.corr.txt", "ev4.4-mer.corr.txt",
            "pred.tsv.scaled.tsv.gz", "s.tsv.gz"} <= set(t_files)
    assert any(f.startswith("motif") for f in t_files)
    for f in t_files:
        assert t_files[f] == j_files[f], f
    assert t_printed == j_printed
    header = t_files["s.tsv.gz"].split("\n", 1)[0].split("\t")
    assert header == HEADER


def _text(path):
    with ttsv.open_text(str(path)) as fh:
        return fh.read()


def test_entry_points_need_a_card_or_raise(data, monkeypatch):
    """Without --cpu_only and without a card, train, predict,
    predict_genome, transfer and convert raise."""
    import torch
    base, fasta, bed = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["train", "--ref_genome", fasta, "--train_data", bed])
    argv = _predict_argv(fasta, bed, "m", "p.tsv")
    argv.remove("--cpu_only")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(argv)
    for argv in (["transfer", "--ref_genome", fasta, "--train_data", bed,
                  "--model_path", "m", "--model_config_path", "c"],
                 ["convert", "--checkpoint_dir", "d", "--out_dir", "o"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["predict_genome", "--ref_genome", fasta, "--model_path",
                  "m", "--model_config_path", "c"])
    with pytest.raises(ValueError, match="model_no for indel"):
        port_cli(["train", "--cpu_only", "--ref_genome", fasta,
                  "--train_data", bed, "--model_no", "2"])


@pytest.mark.parametrize("argv", [
    ["train", "--ref_genome", "g", "--train_data", "b"],
    ["predict", "--ref_genome", "g", "--test_data", "b", "--model_path", "m",
     "--model_config_path", "c"],
    ["evaluate", "--pred_file", "p"],
    ["scale", "--pred_file", "p", "--scale_factor", "1"],
    ["calc_scaling_factor", "--pred_files", "p"],
    ["get_best_model", "--trial_path", "t"]], ids=lambda a: a[0])
def test_parsers_match_jax(argv):
    """Every mural_indel sub-command the port runs takes the JAX
    package's flags with its defaults (the INDEL train defaults included,
    and no local-branch flags); train adds the port's --cpu_only."""
    from mural_tpu.cli.main import create_parser as j_create_parser
    from mural_tpu_torch.cli.main import create_parser
    ours = vars(create_parser("indel").parse_args(argv))
    theirs = vars(j_create_parser("indel").parse_args(argv))
    assert set(ours) - set(theirs) == ({"cpu_only"} if argv[0] == "train"
                                       else set())
    assert {k: ours[k] for k in theirs} == theirs


@pytest.mark.parametrize("extra", [[], SMALL + ["--learning_rate", "0.002",
                                                "--weight_decay_auto", "0"]],
                         ids=["defaults", "small"])
def test_train_config_matches_jax(extra):
    """The standalone trial config that becomes ``model.config.pkl``
    equals the JAX package's for the same mural_indel train argv."""
    from mural_tpu.cli.main import _build_space
    from mural_tpu.cli.main import create_parser as j_create_parser
    from mural_tpu_torch.cli.main import _build_space as _port_space
    from mural_tpu_torch.cli.main import create_parser
    argv = ["train", "--ref_genome", "g", "--train_data", "b", *extra]
    ours = _port_space(create_parser("indel").parse_args(argv), "indel")
    theirs = _build_space(j_create_parser("indel").parse_args(argv), "indel")
    assert ours == theirs
    assert ours["local_radius"] == 6 and ours["down_list"]
