"""``mural_snv train`` and ``predict`` of the port with ``--bw_paths``
track features and the other SNV model numbers, against the JAX package
on the CPU: one ``train_trial`` epoch of SNVNet3 with track channels and
of SNVNet0 from the same initial weights (validation loss within 1e-4),
a predict of a mural_tpu-written SNVNet3 triple with track channels
through both CLIs (same rows, probabilities within ``%.4g``, Mean Loss
within 1e-5 relative), the predict guards, and CLI train runs of
``--model_no 1`` and ``--without_bw_distal`` with the fused stem (the
plain versions of K2/K3 on the CPU), and ``mural_indel`` train and
predict with ``--bw_paths``.  Every dropout is 0 in the epoch runs: Flax
and torch draw their dropout masks from different generators."""
import gzip
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import mural_tpu.train.loop as j_loop
from mural_tpu.calibrate.dirichlet import FullDirichletCalibrator
from mural_tpu.cli.main import main as jax_main
from mural_tpu.data.dataset import prepare_dataset as j_prepare_dataset
from mural_tpu.genome.tracks import TrackSet as JTrackSet
from mural_tpu.genome.tracks import read_track_list
from mural_tpu.predict.pipeline import build_model_from_config
from mural_tpu.train.checkpoint import save_checkpoint
from mural_tpu_torch.cli.mural_snv import main as port_cli
from mural_tpu_torch.predict import PredictOptions, run_predict
from mural_tpu_torch.train import loop
from mural_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_snv_family import one_torch_thread  # noqa: F401
from test_torch_port_tracks import write_genome, write_tracks
from test_torch_port_train import CONFIG, _rel

CHROMS = {"chr1": 40_000, "chr2": 12_000}
# relative tolerance of the epoch's validation loss and of predict's
# Mean Loss, port against JAX
LOSS_TOL = 1e-4
MEAN_LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_track_train")
    rng = np.random.default_rng(23)
    fasta, bed = write_genome(base, rng, CHROMS, 480)
    return dict(base=base, fasta=fasta, bed=bed,
                tracks=write_tracks(base, rng, CHROMS))


@pytest.mark.parametrize("model_no,with_tracks", [(3, True), (0, False)],
                         ids=["model3-bw_paths", "model0"])
def test_train_trial_one_epoch_matches_jax(data, monkeypatch, model_no,
                                           with_tracks):
    """One epoch of each package's host-fed ``train_trial`` from the same
    initial weights (the port's init patched to load the JAX init through
    the weight bridge), learning rate 1e-4 as in
    tests/test_torch_port_train_trial.py: validation loss within 1e-4,
    the same parameter count, trial files and checkpoint config."""
    captured = {}
    j_init = j_loop._init_variables

    def capture(model, ds, seed):
        captured["v"] = jax.tree.map(np.asarray, j_init(model, ds, seed))
        return captured["v"]

    monkeypatch.setattr(j_loop, "_init_variables", capture)
    common = dict(train_data=data["bed"], ref_genome=data["fasta"],
                  epochs=1, valid_ratio=0.5, split_seed=0, rng_seed=1,
                  model_no=model_no,
                  bw_paths=data["tracks"] if with_tracks else None)
    name = f"m{model_no}"
    jdir, tdir = (str(data["base"] / f"jax_{name}"),
                  str(data["base"] / f"port_{name}"))
    config = dict(CONFIG, learning_rate=1e-4)
    jm = j_loop.train_trial(config, j_loop.TrainOptions(
        trial_dir=jdir, resident="off", steps_per_dispatch=1, **common),
        "snv")

    def load_jax_init(model, ds, seed):
        model.load_state_dict(state_dict_from_jax(captured["v"], model),
                              strict=True)
        return model

    monkeypatch.setattr(loop, "init_model", load_jax_init)
    tm = loop.train_trial(config, loop.TrainOptions(
        trial_dir=tdir, device="cpu", **common), "snv")
    assert np.isfinite(tm["loss"]) and np.isfinite(tm["score"])
    assert _rel(tm["loss"], jm["loss"]) <= LOSS_TOL, (tm["loss"],
                                                      jm["loss"])
    assert tm["total_params"] == jm["total_params"]
    saved = []
    for trial_dir in (tdir, jdir):
        with open(os.path.join(trial_dir, "checkpoint_0",
                               "model.config.pkl"), "rb") as fh:
            saved.append(pickle.load(fh))
    assert saved[0] == saved[1]
    assert saved[0]["n_cont"] == (2 if with_tracks else 0)
    sd = torch.load(os.path.join(tdir, "checkpoint_0", "model"),
                    weights_only=True)
    if model_no == 3:
        assert sd["conv1.0.weight"].shape == (6,)
        assert sd["local_fc2.2.weight"].shape == (4, 2)
    else:
        assert "model.output_layer.weight" in sd


@pytest.fixture(scope="module")
def triple(data):
    """A mural_tpu-written SNVNet3 triple trained with the two tracks as
    continuous features and distal channels (random weights and BN
    statistics, a fitted calibrator)."""
    rng = np.random.default_rng(29)
    files, names, radii = read_track_list(data["tracks"], 3)
    ds = j_prepare_dataset(data["bed"], data["fasta"], central_bp=4000,
                           local_radius=3, local_order=2, distal_radius=200,
                           tracks=JTrackSet(files, names, radii),
                           bw_distal=True)
    config = dict(CONFIG, model_no=3, n_class=4, n_cont=2, distal_order=1,
                  without_bw_distal=False, seq_only=False,
                  emb_dims=[(17, 2)] * ds.cat.shape[1])
    model = build_model_from_config(config, 2, "snv")
    assert model.in_channels == 6
    v = j_loop._init_variables(model, ds, 0)

    def nontrivial(tree):
        return {k: nontrivial(t) if isinstance(t, dict) else
                (rng.uniform(0.5, 2.0, t.shape) if k in ("scale", "var")
                 else rng.normal(0, 0.2, t.shape) if k in ("bias", "mean")
                 else np.asarray(t)).astype(np.float32)
                for k, t in tree.items()}

    logits = rng.normal(size=(300, 4))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    cal = FullDirichletCalibrator().fit(probs, rng.integers(0, 4, 300))
    path = str(data["base"] / "triple" / "model")
    save_checkpoint(path, nontrivial(v["params"]),
                    nontrivial(v["batch_stats"]), config, calibrator=cal)
    return dict(model=path, n_sites=ds.n_sites)


def _read_pred(path):
    with gzip.open(path, "rt") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh]
    return header, [r[:5] for r in rows], np.asarray(
        [[float(x) for x in r[5:]] for r in rows])


def _mean_loss(text):
    line = next(m for m in text.splitlines() if m.startswith("Mean Loss"))
    return float(line.split(":")[1].split()[0])


def _predict_argv(data, triple, out, extra=()):
    return ["predict", "--ref_genome", data["fasta"], "--test_data",
            data["bed"], "--model_path", triple["model"],
            "--model_config_path", triple["model"] + ".config.pkl",
            "--calibrator_path", triple["model"] + ".fdiri_cal.pkl",
            "--pred_batch_size", "64", "--pred_file", out, *extra]


def test_predict_with_tracks_matches_jax_cli(data, triple, capsys):
    """``predict --bw_paths --pred_time_view`` of the track-channel
    SNVNet3 through both CLIs; ``--fused_inference`` on it prints the
    JAX package's NOTE and changes nothing."""
    outs = {}
    for name, run, extra in (
            ("jax", lambda argv: jax_main("snv", argv), []),
            ("port", port_cli, ["--cpu_only"]),
            ("port_fused", port_cli, ["--cpu_only", "--fused_inference"])):
        out = str(data["base"] / f"pred_{name}.tsv.gz")
        capsys.readouterr()
        assert run(_predict_argv(data, triple, out, [
            "--bw_paths", data["tracks"], "--pred_time_view", *extra])) \
            in (0, None)
        outs[name] = (_read_pred(out), capsys.readouterr().out)
    (jh, jkeys, jprobs), jtext = outs["jax"]
    assert len(jkeys) == triple["n_sites"]
    for name in ("port", "port_fused"):
        (h, keys, probs), text = outs[name]
        assert h == jh and keys == jkeys
        # both files print %.4g: one unit in the 4th digit apart at most
        np.testing.assert_array_less(
            np.abs(probs - jprobs),
            1.1e-3 * np.maximum(np.abs(probs), np.abs(jprobs)) + 1e-30)
        assert _rel(_mean_loss(text), _mean_loss(jtext)) <= MEAN_LOSS_TOL
        assert "of which track windows" in text
    assert "NOTE: --fused_inference only supports SNV model_no 2" in \
        outs["port_fused"][1]


def test_predict_without_the_tracks_raises(data, triple):
    """A checkpoint trained with track features needs them: the JAX
    package's ValueError in both."""
    opts = dict(test_data=data["bed"], ref_genome=data["fasta"],
                model_path=triple["model"],
                model_config_path=triple["model"] + ".config.pkl",
                pred_file="")
    from mural_tpu.predict import PredictOptions as JOptions
    from mural_tpu.predict import run_predict as j_run_predict
    with pytest.raises(ValueError, match="n_cont=2"):
        j_run_predict(JOptions(**opts), "snv", printer=lambda *a: None)
    with pytest.raises(ValueError, match="n_cont=2"):
        run_predict(PredictOptions(device="cpu", **opts), "snv",
                    printer=lambda *a: None)


SMALL = ["--segment_center", "4000", "--local_radius", "3",
         "--local_order", "2", "--CNN_out_channels", "8",
         "--local_hidden1_size", "30", "--local_hidden2_size", "10",
         "--batch_size", "32", "--epochs", "1", "--valid_ratio", "0.5",
         "--split_seed", "0", "--n_trials", "1"]


@pytest.mark.parametrize("extra,n_cont,fused", [
    (["--model_no", "1", "--fused_stem", "on"], 0, True),
    (["--model_no", "3", "--bw_paths", "TRACKS", "--without_bw_distal",
      "--fused_stem", "on"], 2, True),
    (["--model_no", "3", "--bw_paths", "TRACKS", "--fused_stem", "on"],
     2, False),
    (["--model_no", "2", "--bw_paths", "TRACKS", "--seq_only"], 0, False)],
    ids=["model1-fused", "model3-without_bw_distal-fused",
         "model3-bw_paths-unfused", "model2-seq_only"])
def test_cli_train_runs(data, monkeypatch, request, extra, n_cont, fused):
    """The port's CLI trains the other model numbers and the track
    options through one epoch: the checkpoint triple with the expected
    ``n_cont``, finite metrics, and the fused stem on exactly where the
    JAX package's rule turns it on (towers, no track channels)."""
    monkeypatch.chdir(data["base"])
    name = "cli_" + request.node.callspec.id
    argv = ["train", "--cpu_only", "--ref_genome", data["fasta"],
            "--train_data", data["bed"], "--experiment_name", name, *SMALL,
            *[data["tracks"] if a == "TRACKS" else a for a in extra]]
    assert port_cli(argv) == 0
    exp = data["base"] / "results" / name
    (trial,) = [d for d in os.listdir(exp) if d.startswith("Train_")]
    ck = exp / trial / "checkpoint_0"
    assert not (exp / trial / "error.txt").exists()
    assert sorted(os.listdir(ck)) == ["epoch_0_metrics.txt", "model",
                                      "model.config.pkl",
                                      "model.fdiri_cal.pkl"]
    with open(ck / "model.config.pkl", "rb") as fh:
        assert pickle.load(fh)["n_cont"] == n_cont
    metrics = dict(line.split(": ", 1) for line in
                   (ck / "epoch_0_metrics.txt").read_text().splitlines())
    assert np.isfinite(float(metrics["loss"]))
    log = (exp / trial / "training.log").read_text()
    assert ("fused train stem: on" in log) == fused


def test_indel_cli_with_tracks(tmp_path, monkeypatch):
    """``mural_indel train --bw_paths`` and ``predict --bw_paths`` through
    the port's CLI (small widths): the U-Net's stem takes the 4 + 2
    distal channels, the config records ``n_cont`` 2, and predict writes
    every site with probabilities summing to 1."""
    from mural_tpu_torch.cli.mural_indel import main as indel_cli
    from test_torch_port_indel_train import write_indel_data
    rng = np.random.default_rng(31)
    fasta, bed = write_indel_data(tmp_path, rng)
    tracks = write_tracks(tmp_path, rng, {"chr1": 40_000, "chr2": 12_000})
    monkeypatch.chdir(tmp_path)
    assert indel_cli([
        "train", "--cpu_only", "--ref_genome", fasta, "--train_data", bed,
        "--experiment_name", "indel_tracks", "--n_trials", "1", "--epochs",
        "1", "--use_reverse", "--distal_radius", "100", "--down_list", "1",
        "2", "2", "5", "5", "1", "--CNN_out_channels", "4", "--batch_size",
        "32", "--n_class", "8", "--valid_ratio", "0.5", "--split_seed", "0",
        "--segment_center", "4000", "--bw_paths", tracks]) == 0
    exp = tmp_path / "results" / "indel_tracks"
    (trial,) = [d for d in os.listdir(exp) if d.startswith("Train_")]
    ck = exp / trial / "checkpoint_0"
    with open(ck / "model.config.pkl", "rb") as fh:
        assert pickle.load(fh)["n_cont"] == 2
    sd = torch.load(ck / "model", weights_only=True)
    assert sd["conv.0.weight"].shape[1] == 6
    out = str(tmp_path / "pred.tsv.gz")
    assert indel_cli([
        "predict", "--cpu_only", "--ref_genome", fasta, "--test_data", bed,
        "--model_path", str(ck / "model"), "--model_config_path",
        str(ck / "model.config.pkl"), "--calibrator_path",
        str(ck / "model.fdiri_cal.pkl"), "--pred_file", out,
        "--pred_batch_size", "64", "--bw_paths", tracks]) == 0
    header, keys, probs = _read_pred(out)
    assert header[5:] == [f"prob{i}" for i in range(8)]
    assert len(keys) == sum(1 for _ in open(bed))
    assert np.all(np.abs(probs.sum(1) - 1) <= 5e-4 * np.abs(probs).sum(1)
                  + 1e-6)
