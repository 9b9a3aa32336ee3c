"""The port's training slice (``mural_snv train``) against the JAX
package on the CPU, the parts outside the train step: LR schedules and
weight decay, the segment split, the calibrator fits, the train flags
that reach the trial runner and the options that raise as in the JAX
package.  The train step is in ``test_torch_port_train_step.py``
and one epoch of ``train_trial`` with the CLI drive in
``test_torch_port_train_trial.py``; both take ``CONFIG`` from here."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

import mural_tpu.train.loop as j_loop
from mural_tpu.calibrate.dirichlet import \
    FullDirichletCalibrator as JFullDirichlet
from mural_tpu.train import optim as j_optim
from mural_tpu_torch.calibrate.dirichlet import FullDirichletCalibrator
from mural_tpu_torch.cli.mural_snv import main as port_cli
from mural_tpu_torch.train import loop
from mural_tpu_torch.train.optim import (LRSchedule, ReduceLROnPlateau,
                                         auto_weight_decay)
from test_torch_port_indel_model import one_torch_thread  # noqa: F401

# small SNVNet2 widths; CLI defaults otherwise
CONFIG = dict(
    segment_center=4000, distal_radius=200, CNN_kernel_size=3,
    CNN_out_channels=8, batch_size=32, sampled_segments=2,
    learning_rate=1e-3, optim="Adam", lr_scheduler="StepLR", LR_gamma=0.9,
    weight_decay=1e-5, weight_decay_auto=0.1, restart_lr=1e-4, min_lr=1e-6,
    transfer_learning=False, local_radius=3, local_order=2,
    local_hidden1_size=30, local_hidden2_size=10, emb_dropout=0.0,
    distal_fc_dropout=0.0, local_dropout=0.0)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("name,batch_size,train_size", [
    ("StepLR", 64000, 10 ** 7),     # decays every 10 steps, restarts
    ("StepLR2", 32, 1600),          # 50 steps per epoch, restarted each
    ("constant", 32, 1600)])
def test_lr_schedules_match_jax(name, batch_size, train_size):
    args = (name, 1e-3, 0.5, batch_size, train_size, 1e-4, 1e-6)
    ours, theirs = LRSchedule.build(*args), j_optim.LRSchedule.build(*args)
    assert ours.step_size == theirs.step_size
    assert ours.steps_per_epoch == theirs.steps_per_epoch
    spe = ours.steps_per_epoch
    for epoch in range(3):
        for step in range(epoch * spe, epoch * spe + min(spe, 150) + 5):
            want = float(theirs.lr_at(jnp.asarray(step), jnp.asarray(epoch)))
            got = ours.lr_at(step, epoch)
            # the JAX schedule runs in float32: gamma's rounding (up to
            # 6e-8 relative) compounds once per decay (at most one per
            # step here), and the pow and the cast add a few ulps
            assert _rel(got, want) <= 6e-8 * (step + 4), (step, epoch)


def test_rop_and_weight_decay_match_jax():
    ours, theirs = ReduceLROnPlateau(1e-3), j_optim.ReduceLROnPlateau(1e-3)
    for metric in (1.0, 0.9, 0.95, 0.94, 0.9399, 0.96, 0.97, 0.5, 0.6, 0.7):
        assert ours.step(metric) == theirs.step(metric)
    for wda, bs, epochs, size, wd in ((0.1, 128, 10, 50000, 1e-5),
                                      (0.5, 32, 3, 999, 0.0),
                                      (None, 128, 10, 100, 3e-4),
                                      (0.0, 128, 10, 100, 3e-4)):
        want = j_optim.auto_weight_decay(wda, bs, epochs, size, wd)
        assert _rel(auto_weight_decay(wda, bs, epochs, size, wd),
                    want) <= 1e-7
    with pytest.raises(ValueError, match="smaller than 1"):
        auto_weight_decay(1.0, 128, 10, 100, 0.0)


@pytest.mark.parametrize("n", [1, 7, 100, 1234])
def test_segment_split_matches_jax(n):
    for ratio, seed in ((0.1, 0), (0.25, 7), (0.5, 2 ** 33 + 5)):
        ours = loop.split_segments_like_torch(n, ratio, seed)
        theirs = j_loop.split_segments_like_torch(n, ratio, seed)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_full_dirichlet_fit_matches_jax():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 4, size=3000)
    logits = rng.normal(size=(3000, 4)) + 1.5 * np.eye(4)[y]
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ours = FullDirichletCalibrator().fit(probs, y)
    theirs = JFullDirichlet().fit(probs, y)
    np.testing.assert_allclose(ours.weights_, theirs.weights_, rtol=0,
                               atol=1e-8)
    assert abs(ours.final_loss_ - theirs.final_loss_) <= 1e-10
    np.testing.assert_allclose(ours.predict_proba(probs[:50]),
                               theirs.predict_proba(probs[:50]), rtol=1e-8)


@pytest.mark.parametrize("name", ["FullDiri", "TempS", "VectS",
                                  "FullDiriODIR"])
def test_calibrate_prob_matches_jax(name):
    """calibrate_prob's fit and its before/after metrics against JAX."""
    from mural_tpu.calibrate.fit import calibrate_prob as j_calibrate_prob
    from mural_tpu_torch.calibrate.fit import calibrate_prob
    rng = np.random.default_rng(6)
    y = rng.integers(0, 4, size=2000)
    logits = rng.normal(size=(2000, 4)) + np.eye(4)[y]
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    lines = {}
    for key, fn in (("port", calibrate_prob), ("jax", j_calibrate_prob)):
        out = []
        cal, nll = fn(probs, y, name, printer=lambda *a: out.append(a))
        lines[key] = (cal, nll, out)
    (cal, nll, out), (j_cal, j_nll, j_out) = lines["port"], lines["jax"]
    # at the optimum a Newton step changes the loss by ~1e-16, and float64
    # round-off decides whether it counts as an improvement: one solver
    # may take a last ~1e-7 step that the other declines
    np.testing.assert_allclose(cal.weights_, j_cal.weights_, rtol=0,
                               atol=1e-6)
    assert abs(nll - j_nll) <= 1e-10
    assert [a[0] for a in out] == [a[0] for a in j_out]
    # the before/after lines print ECE, CwECE and Brier to 8 digits
    assert out[-2:] == j_out[-2:]


# every flag of the JAX package runs now: ``--with_h5`` trains one CPU
# epoch through the site-table cache, and ``--dp_devices 2`` on two CPU
# ranks; the cases keep their ids
@pytest.mark.parametrize("flag,line", [
    pytest.param(["--with_h5", "--h5f_path", "h5", "--n_h5_files", "2"],
                 "wrote site-encoding cache (2 file(s)):", id="flag1-4"),
    pytest.param(["--dp_devices", "2"],
                 "data-parallel training over 2 devices (gloo)",
                 id="flag2-10")])
def test_cli_train_flags_not_ported_raise(small_data, tmp_path, monkeypatch,
                                          flag, line):
    fasta, bed = small_data
    monkeypatch.chdir(tmp_path)
    assert port_cli([
        "train", "--ref_genome", fasta, "--train_data", bed,
        "--experiment_name", "t", "--n_trials", "1", "--epochs", "1",
        "--cpu_only", "--batch_size", "32", "--CNN_out_channels", "8",
        "--local_hidden1_size", "30", "--local_hidden2_size", "10",
        "--valid_ratio", "0.2", "--split_seed", "0", "--segment_center",
        "2000", *flag]) == 0
    trial = next((tmp_path / "results" / "t").glob("Train_*"))
    text = (trial / "training.log").read_text()
    assert line in text
    assert "Epoch 0 used time" in text and "Best Epoch: 0" in text
    assert not (trial / "error.txt").exists()
    assert sorted(os.listdir(trial / "checkpoint_0")) == [
        "epoch_0_metrics.txt", "model", "model.config.pkl",
        "model.fdiri_cal.pkl"]
    if "--with_h5" in flag:
        # the training BED's cache (a master and 2 shards) under the
        # relative --h5f_path, which the JAX package's loader takes
        from mural_tpu.data.cache import is_cache_fresh
        (master,) = (tmp_path / "h5").glob("*.sites.h5")
        assert len(list((tmp_path / "h5").glob("*.sites.h5.part*"))) == 2
        assert is_cache_fresh(str(master), bed)


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    from test_torch_port_tracks import write_genome
    base = tmp_path_factory.mktemp("port_train_flags")
    return write_genome(base, np.random.default_rng(2), {"chr1": 20_000},
                        150)


@pytest.mark.parametrize("flag,field,value,line", [
    (["--steps_per_dispatch", "4"], "steps_per_dispatch", 4,
     "4 eager train steps per group"),
    (["--resident_data", "on"], "resident", "on",
     "device-resident data: train arena"),
    (["--resident_data", "off", "--steps_per_dispatch", "1"], "resident",
     "off", None),
    (["--profile_dir", "prof"], "profile_dir", "prof",
     "profiler trace written to prof"),
    (["--bf16", "--fused_stem", "on"], "bf16", True,
     "mixed precision: bfloat16 activations"),
    # one trial: no group to ensemble, so the trial runs serially
    (["--trial_ensemble", "auto"], "resident", "auto",
     "device-resident data: train arena")])
def test_cli_train_runtime_flags_run(small_data, tmp_path, monkeypatch, flag,
                                     field, value, line):
    """``--steps_per_dispatch``, ``--resident_data``, ``--profile_dir``,
    ``--bf16`` and ``--trial_ensemble`` reach the runner and train one
    epoch on the CPU; the trial log says how the steps ran."""
    import mural_tpu_torch.tune.runner as runner
    fasta, bed = small_data
    seen = []

    def train_trial(config, opts, *a, **kw):
        seen.append(opts)
        return loop.train_trial(config, opts, *a, **kw)

    monkeypatch.setattr(runner, "train_trial", train_trial)
    monkeypatch.chdir(tmp_path)
    assert port_cli([
        "train", "--ref_genome", fasta, "--train_data", bed,
        "--experiment_name", "t", "--n_trials", "1", "--epochs", "1",
        "--cpu_only", "--batch_size", "32", "--CNN_out_channels", "8",
        "--local_hidden1_size", "30", "--local_hidden2_size", "10",
        "--valid_ratio", "0.2", "--split_seed", "0", "--segment_center",
        "2000", *flag]) == 0
    assert len(seen) == 1 and getattr(seen[0], field) == value
    trial = next((tmp_path / "results" / "t").glob("Train_*"))
    text = (trial / "training.log").read_text()
    assert "Epoch 0 used time" in text
    assert not (trial / "error.txt").exists()
    if line is None:
        assert "device-resident data" not in text
        assert "train steps per" not in text
    else:
        assert line in text
    if field == "profile_dir":
        assert (tmp_path / "prof" / "train_epoch0.pt.trace.json").exists()


@pytest.mark.parametrize("flag,field,value", [
    (["--use_ray"], "use_scheduler", True),
    (["--n_parallel", "2"], "n_parallel", 2),
    (["--trial_executor", "process"], "trial_executor", "process"),
    (["--rerun_failed"], "rerun_failed", True)])
@pytest.mark.parametrize("cpu_only", [True, False], ids=["cpu", "no_card"])
def test_cli_train_search_flags_reach_the_runner(monkeypatch, flag, field,
                                                 value, cpu_only):
    """The trial-search flags reach the experiment runner on a CPU train;
    without ``--cpu_only`` and without a card, train raises "no CUDA
    device" before any trial."""
    import torch

    import mural_tpu_torch.tune.runner as runner
    got = {}
    monkeypatch.setattr(runner, "run_experiment",
                        lambda space, opts, mt, exp: got.update(
                            exp=exp, opts=opts))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["train", "--ref_genome", "seq.fa", "--train_data", "sites.bed",
            *flag] + (["--cpu_only"] if cpu_only else [])
    if not cpu_only:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli(argv)
        assert not got
        return
    assert port_cli(argv) == 0
    assert getattr(got["exp"], field) == value
    assert str(got["opts"].device) == "cpu"


@pytest.mark.parametrize("model_no", [0, 1, 2, 3])
def test_train_accepts_every_snv_model_no(model_no):
    """SNVNet0-3 pass the checks that run before any trial starts (the
    CLI trains each: tests/test_torch_port_track_train.py)."""
    loop.check_ported(loop.TrainOptions(train_data="sites.bed",
                                        ref_genome="seq.fa",
                                        model_no=model_no))


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    from test_torch_port_tracks import write_genome
    base = tmp_path_factory.mktemp("port_train_raise")
    return write_genome(base, np.random.default_rng(2), {"chr1": 3000}, 20)


@pytest.mark.parametrize("option,error,match", [
    ({"distal_order": 2}, NotImplementedError,
     "distal_order > 1 is reserved in the reference too"),
    ({"bw_paths": "absent_tracks.txt"}, FileNotFoundError,
     "absent_tracks.txt")])
def test_train_trial_raises_like_jax(tiny_data, tmp_path, option, error,
                                     match):
    """``--distal_order 2`` (reserved in the JAX package too) and a
    missing ``--bw_paths`` list reach ``train_trial`` and raise there the
    JAX package's error."""
    fasta, bed = tiny_data
    common = dict(train_data=bed, ref_genome=fasta, epochs=1, split_seed=0,
                  **option)
    with pytest.raises(error, match=match):
        j_loop.train_trial(CONFIG, j_loop.TrainOptions(
            trial_dir=str(tmp_path / "jax"), resident="off", **common),
            "snv")
    with pytest.raises(error, match=match):
        loop.train_trial(CONFIG, loop.TrainOptions(
            trial_dir=str(tmp_path / "port"), device="cpu", **common),
            "snv")
