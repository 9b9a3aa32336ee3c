"""One epoch of the port's ``train_trial`` against the JAX package's on
a tiny synthetic set (with its k-mer and regional evaluation, exactly
when both tails see the same probabilities), the batches both draw, and
train -> get_best_model -> predict through the port's CLI (CPU, fused
stem with the plain versions of K2/K3).  Every dropout is 0: Flax and torch draw their
dropout masks from different generators."""
import gzip
import os
import pickle

import jax
import numpy as np
import pytest

import mural_tpu.train.loop as j_loop
from mural_tpu.data.dataset import prepare_dataset as j_prepare_dataset
from mural_tpu.genome.fasta import decode_sequence
from mural_tpu_torch.cli.mural_snv import main as port_cli
from mural_tpu_torch.train import loop
from mural_tpu_torch.train.checkpoint import load_calibrator
from mural_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_train import CONFIG, _rel

# relative tolerance of one epoch's regional score, port against JAX
SCORE_TOL = 1e-4
# the epoch tail's evaluation lines of the uncalibrated and the
# Poisson-calibrated probabilities (the FullDirichlet fits differ)
_EVAL_LINES = ("mer correlation - all", "after Poisson_cal",
               "regional corr (validation):", "corr_list: ",
               "regional score: ", "n_regions", "Warning: too")


def _write_data(base, rng, n_per_strand=480):
    """A FASTA and a sorted BED of SNV sites ('+' on A, '-' on T), with
    labels 0..3 spread evenly so every class reaches validation."""
    fasta, bed = base / "seq.fa", base / "sites.bed"
    rows = []
    with open(fasta, "w") as fh:
        for chrom, n in (("chr1", 40_000), ("chr2", 12_000)):
            codes = rng.integers(0, 4, size=n).astype(np.uint8)
            codes[rng.integers(0, n, size=n // 200)] = 14
            fh.write(f">{chrom}\n{decode_sequence(codes)}\n")
            for strand, base_code in (("+", 0), ("-", 3)):
                pos = rng.choice(np.flatnonzero(codes == base_code),
                                 size=n_per_strand if chrom == "chr1"
                                 else n_per_strand // 4, replace=False)
                rows += [(chrom, int(p), strand, i % 4)
                         for i, p in enumerate(pos)]
    rows.sort(key=lambda r: (r[0], r[1]))
    with open(bed, "w") as fh:
        for chrom, p, strand, label in rows:
            fh.write(f"{chrom}\t{p}\t{p + 1}\t.\t{label}\t{strand}\n")
    return str(fasta), str(bed)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_train")
    return (base,) + _write_data(base, np.random.default_rng(3))


def test_split_batches_and_frames_match_jax(data):
    """The segment split, the training batches (shuffled, remainder
    dropped) and the validation batches (in order, padded and masked)
    draw the same rows as the JAX package's from the same seeds."""
    from mural_tpu.data.batcher import iter_batch_rows as j_iter_rows
    from mural_tpu_torch.data.batcher import iter_batch_rows
    from mural_tpu_torch.data.dataset import prepare_dataset
    _, fasta, bed = data
    kw = dict(central_bp=4000, local_radius=3, local_order=2,
              distal_radius=200)
    ds, jds = prepare_dataset(bed, fasta, **kw), j_prepare_dataset(
        bed, fasta, **kw)
    assert ds.cat_dims == jds.cat_dims
    train_ids, valid_ids = loop.split_segments_like_torch(ds.n_segments,
                                                          0.25, 0)
    for ids in (train_ids, valid_ids):
        sub, jsub = ds.subset_segments(ids), jds.subset_segments(ids)
        np.testing.assert_array_equal(sub.seg_offsets, jsub.seg_offsets)
        np.testing.assert_array_equal(sub.start, jsub.start)
        frame, jframe = sub.local_frame(), jsub.local_frame()
        assert list(frame) == list(jframe.columns)
        for col in frame:
            np.testing.assert_array_equal(frame[col], jframe[col].to_numpy())
        for shuffle, pad in ((True, False), (False, True)):
            ours = list(iter_batch_rows(sub, 2, 32, shuffle=shuffle,
                                        rng=np.random.default_rng(9),
                                        pad_final=pad))
            theirs = list(j_iter_rows(jsub, 2, 32, shuffle=shuffle,
                                      rng=np.random.default_rng(9),
                                      pad_final=pad))
            assert len(ours) == len(theirs) > 0
            for (rows, n), (j_rows, j_n) in zip(ours, theirs):
                assert n == j_n
                np.testing.assert_array_equal(rows, j_rows)


def _trial_files(trial_dir):
    return sorted(os.path.relpath(os.path.join(d, f), trial_dir)
                  for d, _, files in os.walk(trial_dir) for f in files)


def test_train_trial_one_epoch_matches_jax(data, monkeypatch):
    """One epoch of the port's train_trial (CPU, fused stem) against the
    JAX package's host-fed single-step train_trial (fused stem), from the
    same initial weights: the port's init is patched to load the JAX
    init through the weight bridge.  The learning rate is 1e-4: at 1e-3
    the two float32 trajectories drift apart chaotically (a 1e-7 step
    difference flips a tied pool argmax or an Adam step sign and grows
    to ~3e-4 in validation loss over this epoch's 9 steps, fused or
    unfused alike), which the step test above bounds step by step."""
    base, fasta, bed = data
    captured = {}
    j_init = j_loop._init_variables

    def capture(model, ds, seed):
        captured["v"] = jax.tree.map(np.asarray, j_init(model, ds, seed))
        return captured["v"]

    monkeypatch.setattr(j_loop, "_init_variables", capture)
    # half the segments validate: the calibration fit is then well
    # conditioned, so the two fits agree to 1e-3
    common = dict(train_data=bed, ref_genome=fasta, epochs=1,
                  valid_ratio=0.5, split_seed=0, rng_seed=1,
                  fused_stem="on")
    jdir, tdir = str(base / "jax_trial"), str(base / "port_trial")
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
    assert _rel(tm["loss"], jm["loss"]) <= 1e-4
    assert _rel(tm["fdiri_loss"], jm["fdiri_loss"]) <= 1e-3
    assert tm["total_params"] == jm["total_params"]
    # the regional score sums (1 - r)^2 over k-mer correlations of 60-site
    # regions, so it follows the two trainers' probabilities more closely
    # than the loss does: measured 3.4e-6 relative apart on this epoch
    assert _rel(tm["score"], jm["score"]) <= SCORE_TOL
    cal_t = load_calibrator(os.path.join(tdir, "checkpoint_0",
                                         "model.fdiri_cal.pkl"))
    with open(os.path.join(jdir, "checkpoint_0", "model.fdiri_cal.pkl"),
              "rb") as fh:
        cal_j = pickle.load(fh)
    np.testing.assert_allclose(cal_t.weights_, cal_j.weights_, rtol=0,
                               atol=1e-3)
    assert _trial_files(tdir) == _trial_files(jdir)
    saved = []
    for trial_dir in (tdir, jdir):
        with open(os.path.join(trial_dir, "checkpoint_0",
                               "model.config.pkl"), "rb") as fh:
            saved.append(pickle.load(fh))
    assert saved[0] == saved[1]


def test_epoch_tail_on_jax_probabilities(data, monkeypatch, capsys):
    """--save_valid_preds and --poisson_calib, with the port's epoch tail
    fed the JAX run's validation probabilities (the port's validation
    softmax is patched to return them): the same score to 1e-12, the
    same evaluation lines, the same trial files, and the same
    ``model.valid_preds.tsv.gz`` (decompressed)."""
    base, fasta, bed = data
    captured = []
    j_calibrate = j_loop.calibrate_prob

    def capture(probs, *a, **kw):
        captured.append(np.array(probs))
        return j_calibrate(probs, *a, **kw)

    monkeypatch.setattr(j_loop, "calibrate_prob", capture)
    common = dict(train_data=bed, ref_genome=fasta, epochs=1,
                  valid_ratio=0.5, split_seed=0, rng_seed=1,
                  save_valid_preds=True, poisson_calib=True)
    jdir, tdir = str(base / "jax_tail"), str(base / "port_tail")
    capsys.readouterr()
    jm = j_loop.train_trial(CONFIG, j_loop.TrainOptions(
        trial_dir=jdir, resident="off", steps_per_dispatch=1, **common),
        "snv")
    j_out = capsys.readouterr().out
    (probs,) = captured
    monkeypatch.setattr(loop, "_softmax", lambda logits: probs)
    tm = loop.train_trial(CONFIG, loop.TrainOptions(
        trial_dir=tdir, device="cpu", **common), "snv")
    t_out = capsys.readouterr().out
    assert abs(tm["score"] - jm["score"]) <= 1e-12 * abs(jm["score"])
    assert np.isfinite(tm["score"])
    lines = [[line for line in out.splitlines() if line.startswith(
        _EVAL_LINES) or any(s in line for s in _EVAL_LINES[:2])]
        for out in (t_out, j_out)]
    assert lines[0] == lines[1]
    assert sum("after Poisson_cal" in line for line in lines[0]) == 7
    assert _trial_files(tdir) == _trial_files(jdir)
    assert "checkpoint_0/model.valid_preds.tsv.gz" in _trial_files(tdir)
    preds = []
    for trial_dir in (tdir, jdir):
        with gzip.open(os.path.join(trial_dir, "checkpoint_0",
                                    "model.valid_preds.tsv.gz"), "rb") as fh:
            preds.append(fh.read())
    assert preds[0] == preds[1]


def test_cli_train_get_best_model_predict(data, monkeypatch, capsys):
    base, fasta, bed = data
    monkeypatch.chdir(base)
    small = ["--segment_center", "4000", "--local_radius", "3",
             "--local_order", "2", "--CNN_out_channels", "8",
             "--local_hidden1_size", "30", "--local_hidden2_size", "10",
             "--batch_size", "32"]
    assert port_cli(["train", "--cpu_only", "--ref_genome", fasta,
                     "--train_data", bed, "--experiment_name", "cli",
                     "--n_trials", "1", "--epochs", "2", "--valid_ratio",
                     "0.25", "--split_seed", "0", "--fused_stem", "on",
                     *small]) == 0
    (trial,) = [d for d in os.listdir(base / "results" / "cli")
                if d.startswith("Train_")]
    assert trial.endswith("_00000")
    assert (base / "results" / "cli" / "best_models.txt").exists()
    for epoch in (0, 1):
        ck = base / "results" / "cli" / trial / f"checkpoint_{epoch}"
        assert sorted(os.listdir(ck)) == [
            f"epoch_{epoch}_metrics.txt", "model", "model.config.pkl",
            "model.fdiri_cal.pkl"]
    progress = (base / "results" / "cli" / trial / "progress.csv"
                ).read_text().splitlines()
    assert progress[0] == "epoch,loss,fdiri_loss,after_min_loss,score," \
                          "total_params" and len(progress) == 3
    assert all(np.isfinite(float(row.split(",")[4])) for row in progress[1:])
    capsys.readouterr()
    assert port_cli(["get_best_model", "--trial_path", "results/cli"]) == 0
    best, loss = capsys.readouterr().out.splitlines()[-1].split("\t")
    assert best.endswith(f"{trial}/checkpoint_0") or \
        best.endswith(f"{trial}/checkpoint_1")
    assert np.isfinite(float(loss))
    assert port_cli(["predict", "--cpu_only", "--ref_genome", fasta,
                     "--test_data", bed, "--model_path", f"{best}/model",
                     "--model_config_path", f"{best}/model.config.pkl",
                     "--calibrator_path", f"{best}/model.fdiri_cal.pkl",
                     "--pred_file", "pred.tsv.gz", "--fused_inference",
                     "--pred_batch_size", "64"]) == 0
    mean_loss = next(line for line in capsys.readouterr().out.splitlines()
                     if line.startswith("Mean Loss"))
    assert np.isfinite(float(mean_loss.split(":")[1].split()[0]))
