"""The port's trial search (mural_tpu_torch.tune: the search space, the
ASHA scheduler and the experiment runner) against the JAX package's on
the CPU: sampled configs and ASHA verdicts exactly; a scheduled run of
six trials with a scripted trainer in both packages (trial ids, configs,
stop epochs, best_models.txt and every printed line, the progress table
included); ``rerun_failed``; concurrent threads over two CPU "devices";
the process executor on two real trials against the same trials run
in-process; and the per-device dropout seeding."""
import os
import pickle
import random
import threading
import time

import numpy as np
import pytest
import torch

import mural_tpu.train.loop as j_loop
import mural_tpu.tune.runner as j_runner
import mural_tpu_torch.tune.runner as runner
from mural_tpu.cli.main import _build_space as j_build_space
from mural_tpu.cli.main import create_parser as j_create_parser
from mural_tpu.tune.asha import ASHAScheduler as JASHA
from mural_tpu.tune.space import sample_config as j_sample_config
from mural_tpu_torch.cli.main import _build_space, create_parser
from mural_tpu_torch.train import loop
from mural_tpu_torch.tune.asha import ASHAScheduler
from mural_tpu_torch.tune.space import sample_config
from mural_tpu_torch.utils.trials import generate_trial_id
from test_torch_port_train import CONFIG, _rel
from test_torch_port_train_trial import _write_data

SEARCH = {
    "snv": ["--distal_radius", "100", "200", "--CNN_kernel_size", "3", "5",
            "--CNN_out_channels", "16", "32", "--batch_size", "64", "128",
            "256", "--sampled_segments", "5", "10", "--learning_rate",
            "1e-4", "1e-2", "--optim", "Adam", "AdamW", "SGD",
            "--lr_scheduler", "StepLR", "ROP", "--LR_gamma", "0.9", "0.95",
            "--weight_decay", "1e-6", "1e-3", "--local_radius", "5", "7",
            "--local_order", "2", "3", "--local_hidden1_size", "100", "150",
            "--emb_dropout", "0.1", "0.2", "--local_dropout", "0.1", "0.15",
            "--distal_fc_dropout", "0.25", "0.3"],
    "indel": ["--distal_radius", "2000", "4000", "--CNN_kernel_size", "5",
              "7", "--CNN_out_channels", "8", "16", "--batch_size", "64",
              "128", "--learning_rate", "1e-4", "1e-2", "--weight_decay",
              "1e-5", "--optim", "Adam", "AdamW", "--LR_gamma", "0.9",
              "0.95"],
}


def _spaces(model_type, extra=()):
    argv = ["train", "--ref_genome", "g", "--train_data", "b", "--use_ray",
            *SEARCH[model_type], *extra]
    return (_build_space(create_parser(model_type).parse_args(argv),
                         model_type),
            j_build_space(j_create_parser(model_type).parse_args(argv),
                          model_type))


def _transfer_spaces(model_type, tmp_path, monkeypatch):
    """The search space of ``transfer --use_ray`` in both packages, taken
    from a stubbed run_experiment."""
    from mural_tpu.cli import main as j_main
    from mural_tpu_torch.cli import main as t_main
    cfg = dict(local_radius=5, local_order=3, distal_radius=50,
               CNN_kernel_size=3, CNN_out_channels=8, local_hidden1_size=32,
               local_hidden2_size=16, emb_dropout=0.1, local_dropout=0.1,
               distal_fc_dropout=0.25, segment_center=300000,
               sampled_segments=10, n_class=4, model_no=2,
               emb_dims=[(65, 2)] * 11, n_cont=0)
    if model_type == "indel":
        cfg.update(model_no=0, n_class=8, down_list=[1, 2, 2, 5, 5, 1],
                   use_reverse=True)
    path = tmp_path / "model.config.pkl"
    with open(path, "wb") as fh:
        pickle.dump(cfg, fh)
    got = {}
    monkeypatch.setattr("mural_tpu.tune.runner.run_experiment",
                        lambda space, *a, **k: got.update(jax=space))
    monkeypatch.setattr(runner, "run_experiment",
                        lambda space, *a, **k: got.update(port=space))
    argv = ["transfer", "--ref_genome", "g", "--train_data", "b",
            "--model_path", "m", "--model_config_path", str(path),
            "--train_all", "--use_ray", "--batch_size", "64", "128",
            "--optim", "Adam", "AdamW", "--learning_rate", "1e-4", "1e-2",
            "--weight_decay", "1e-6", "1e-3", "--LR_gamma", "0.9", "0.95",
            "--lr_scheduler", "StepLR", "StepLR2"]
    j_main.cmd_transfer(j_create_parser(model_type).parse_args(argv),
                        model_type)
    t_main.cmd_transfer(create_parser(model_type).parse_args(
        argv + ["--cpu_only"]), model_type)
    return got["port"], got["jax"]


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("kind", ["snv", "snv_hidden2", "indel",
                                  "transfer_snv", "transfer_indel"])
def test_sampled_configs_match_jax(kind, seed, tmp_path, monkeypatch):
    """Four configs drawn in a row from one ``default_rng(seed)`` equal
    the JAX package's, key for key (SampleFrom resolved last)."""
    if kind.startswith("transfer"):
        ours, theirs = _transfer_spaces(kind.split("_")[1], tmp_path,
                                        monkeypatch)
    elif kind == "snv_hidden2":
        ours, theirs = _spaces("snv", ["--local_hidden2_size", "40", "60"])
    else:
        ours, theirs = _spaces(kind)
    rng, j_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        got, want = sample_config(ours, rng), j_sample_config(theirs, j_rng)
        assert list(got) == list(want)
        assert got == want
        assert all(type(got[k]) is type(want[k]) for k in want)


@pytest.mark.parametrize("seed", range(25))
def test_asha_verdicts_match_jax(seed):
    """A seeded asynchronous report stream (grace 1-3, max_t 2-12, 1-8
    trials; each report from a trial drawn among those still running,
    ties among the losses on purpose) gets the same verdicts from both
    schedulers."""
    rng = np.random.default_rng(seed)
    grace, max_t = int(rng.integers(1, 4)), int(rng.integers(2, 13))
    n = int(rng.integers(1, 9))
    ours = ASHAScheduler(max_t=max_t, grace_period=grace)
    theirs = JASHA(max_t=max_t, grace_period=grace)
    assert ours.rungs == theirs.rungs
    it = {f"t{i}": 0 for i in range(n)}
    verdicts = []
    while it:
        trial = sorted(it)[int(rng.integers(0, len(it)))]
        it[trial] += 1
        metrics = {"loss": float(rng.choice([rng.random(), 0.5]))}
        got = ours.on_report(trial, it[trial], metrics)
        assert got == theirs.on_report(trial, it[trial], metrics)
        verdicts.append(got)
        if not got or it[trial] >= max_t:
            del it[trial]
    assert len(verdicts) >= n


def _scripted_trial(record=None, fail=()):
    """A stand-in for train_trial: per epoch a loss drawn from the trial's
    seed and learning rate, the metrics file of a checkpoint, the
    after_min_loss count, and the report hook's verdict."""
    def train_trial(config, opts, model_type, report_fn=None):
        if record is not None:
            record.append((os.path.basename(opts.trial_dir), dict(config)))
        if os.path.basename(opts.trial_dir) in fail:
            raise RuntimeError("scripted failure")
        rng = np.random.default_rng(opts.rng_seed)
        min_loss, min_epoch, m = 0.0, 0, {}
        for epoch in range(opts.epochs):
            loss = float(rng.uniform(0.5, 1.5) + config["learning_rate"])
            if epoch == 0 or loss < min_loss:
                min_loss, min_epoch = loss, epoch
            m = {"loss": loss, "fdiri_loss": loss - 0.1,
                 "after_min_loss": epoch - min_epoch, "score": 0.5,
                 "total_params": 10, "epoch": epoch}
            ck = os.path.join(opts.trial_dir, f"checkpoint_{epoch}")
            os.makedirs(ck, exist_ok=True)
            with open(os.path.join(ck, f"epoch_{epoch}_metrics.txt"),
                      "w") as fh:
                fh.writelines(f"{k}: {v}\n" for k, v in m.items())
            if report_fn is not None and report_fn(m) is False:
                break
        return m
    return train_trial


def _run_both(tmp_path, monkeypatch, exp_kw, fail=()):
    """One run_experiment per package with the scripted trainer; returns
    {package: (printed lines with the results dir cut, records)}."""
    space, j_space = _spaces("snv")
    out = {}
    for name, mod, opts, sp in (
            ("jax", j_runner, j_loop.TrainOptions("b", "g"), j_space),
            ("port", runner, loop.TrainOptions("b", "g", device="cpu"),
             space)):
        record = []
        monkeypatch.setattr(mod, "train_trial",
                            _scripted_trial(record, fail))
        results = tmp_path / name
        lines = []
        mod.run_experiment(sp, opts, "snv", mod.ExperimentOptions(
            experiment_name="exp", results_dir=str(results), **exp_kw),
            printer=lambda *a: lines.append(" ".join(map(str, a))))
        out[name] = ([line.replace(str(results), "R") for line in lines],
                     record, results / "exp")
    return out


def _trial_dirs(exp_dir):
    return sorted(d for d in os.listdir(exp_dir) if d.startswith("Train_"))


def test_scheduled_run_matches_jax(tmp_path, monkeypatch):
    """Six trials of six epochs under ASHA (grace 1: rungs 1, 2 and 4)
    and the after_min_loss stop: the same trials, configs, stop epochs,
    best_models.txt and printed lines (the final progress table
    included) as the JAX package's runner."""
    out = _run_both(tmp_path, monkeypatch, dict(
        n_trials=6, epochs=6, grace_period=1, use_scheduler=True, seed=3,
        progress_interval=3600.0))
    (lines, record, exp), (j_lines, j_record, j_exp) = out["port"], \
        out["jax"]
    assert lines == j_lines
    assert record == j_record and len(record) == 6
    assert _trial_dirs(exp) == _trial_dirs(j_exp) == sorted(
        r[0] for r in record)
    stops = {}
    for trial in _trial_dirs(exp):
        with open(exp / trial / "trial_config.pkl", "rb") as fh:
            config = pickle.load(fh)
        with open(j_exp / trial / "trial_config.pkl", "rb") as fh:
            assert config == pickle.load(fh)
        stops[trial] = [len([d for d in os.listdir(e / trial)
                             if d.startswith("checkpoint_")])
                        for e in (exp, j_exp)]
        assert (exp / trial / "progress.csv").read_text() == (
            j_exp / trial / "progress.csv").read_text()
    assert all(a == b for a, b in stops.values())
    # the scheduler stopped some trials before the last epoch
    assert min(a for a, _ in stops.values()) < 6
    best = (exp / "best_models.txt").read_text().replace(str(exp), "E")
    assert best == (j_exp / "best_models.txt").read_text().replace(
        str(j_exp), "E")
    table = [row for line in lines for row in line.splitlines()
             if row.startswith("| Train_")]
    assert len(table) == 6 and all("TERMINATED" in row for row in table)


def test_rerun_failed_reruns_the_errored_trials(tmp_path, monkeypatch):
    """Trials 1 and 3 raise: each leaves error.txt while the others
    finish; ``rerun_failed`` then runs exactly those two again from their
    pickled configs, in both packages, and clears their error.txt."""
    exp_kw = dict(n_trials=4, epochs=2, grace_period=1, seed=5)
    id_rng = random.Random(5)
    failing = [generate_trial_id(i, id_rng) for i in range(4)][1::2]
    out = _run_both(tmp_path, monkeypatch, exp_kw, fail=failing)
    for name, mod, opts in (
            ("jax", j_runner, j_loop.TrainOptions("b", "g")),
            ("port", runner, loop.TrainOptions("b", "g", device="cpu"))):
        lines, record, exp = out[name]
        assert [t for t in _trial_dirs(exp)
                if (exp / t / "error.txt").exists()] == failing
        assert sum("FAILED: scripted failure" in line for line in lines) == 2
        configs = {}
        for t in failing:
            with open(exp / t / "trial_config.pkl", "rb") as fh:
                configs[t] = pickle.load(fh)
        rerun, printed = [], []
        monkeypatch.setattr(mod, "train_trial", _scripted_trial(rerun))
        mod.run_experiment({}, opts, "snv", mod.ExperimentOptions(
            experiment_name="exp", results_dir=str(exp.parent),
            rerun_failed=True, **exp_kw), printer=printed.append)
        assert printed[0] == "rerun_failed: re-running 2 errored trials"
        assert [r[0] for r in rerun] == failing
        assert all(r[1] == configs[r[0]] for r in rerun)
        assert not any((exp / t / "error.txt").exists()
                       for t in _trial_dirs(exp))


def test_threads_over_two_devices(tmp_path, monkeypatch):
    """``n_parallel 2`` over two CPU "devices": two trials at a time, each
    pinned round-robin by launch order; a trial that raises leaves
    error.txt and the others finish."""
    from mural_tpu_torch.tune.runner import ExperimentOptions
    lock, state = threading.Lock(), {"now": 0, "peak": 0, "devices": []}
    scripted = _scripted_trial()

    def trial(config, opts, model_type, report_fn=None):
        with lock:
            state["now"] += 1
            state["peak"] = max(state["peak"], state["now"])
            state["devices"].append(opts.device)
        time.sleep(0.2)
        try:
            if opts.trial_dir.endswith("_00002"):
                raise RuntimeError("trial 2 fails")
            return scripted(config, opts, model_type, report_fn)
        finally:
            with lock:
                state["now"] -= 1

    monkeypatch.setattr(runner, "train_trial", trial)
    devices = [torch.device("cpu"), torch.device("cpu", 0)]
    space, _ = _spaces("snv")
    lines = []
    best = runner.run_experiment(
        space, loop.TrainOptions("b", "g", device="cpu"), "snv",
        ExperimentOptions(experiment_name="exp", results_dir=str(tmp_path),
                          n_trials=5, epochs=2, n_parallel=2, seed=1),
        printer=lambda *a: lines.append(" ".join(map(str, a))),
        devices=devices)
    exp = tmp_path / "exp"
    trials = _trial_dirs(exp)
    assert len(trials) == 5 and len(best) == 4
    assert state["peak"] == 2
    assert sorted(map(str, state["devices"])) == sorted(
        map(str, [devices[i % 2] for i in range(5)]))
    (failed,) = [t for t in trials if t.endswith("_00002")]
    assert [t for t in trials if (exp / t / "error.txt").exists()] == [
        failed]
    assert "trial 2 fails" in (exp / failed / "error.txt").read_text()
    assert sum("finished: loss=" in line for line in lines) == 4


def test_trial_devices_rule(monkeypatch):
    """Trials spread over every CUDA device for a CUDA run, else over the
    one CPU."""
    assert runner.trial_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert runner.trial_devices("cuda:1") == [
        torch.device(f"cuda:{i}") for i in range(3)]
    assert runner.trial_devices(None) == runner.trial_devices("cuda")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_tune")
    return _write_data(base, np.random.default_rng(4), n_per_strand=240)


def _dropout_config():
    return dict(CONFIG, emb_dropout=0.1, local_dropout=0.1,
                distal_fc_dropout=0.25, learning_rate=1e-4)


def _tiny_opts(fasta, bed, trial_dir, **kw):
    return loop.TrainOptions(train_data=bed, ref_genome=fasta, epochs=1,
                             valid_ratio=0.5, split_seed=0,
                             trial_dir=str(trial_dir), device="cpu", **kw)


def test_process_executor_matches_in_process(tiny, tmp_path):
    """``trial_executor='process'``: two real trials, each in a spawned
    process on the CPU, end with the loss of the same trial run here
    (within 1e-5 relative); the dropout masks come from the seeded CPU
    generator in both."""
    from mural_tpu_torch.tune.runner import ExperimentOptions
    fasta, bed = tiny
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        best = runner.run_experiment(
            _dropout_config(), _tiny_opts(fasta, bed, tmp_path, rng_seed=7),
            "snv", ExperimentOptions(
                experiment_name="proc", results_dir=str(tmp_path),
                n_trials=2, epochs=1, seed=2, trial_executor="process"),
            printer=lambda *a: None)
        exp = tmp_path / "proc"
        trials = _trial_dirs(exp)
        assert len(best) == 2 and not any(
            (exp / t / "error.txt").exists() for t in trials)
        for trial in trials:
            metrics = dict(
                line.split(": ", 1) for line in
                (exp / trial / "checkpoint_0" /
                 "epoch_0_metrics.txt").read_text().splitlines())
            here = loop.train_trial(_dropout_config(), _tiny_opts(
                fasta, bed, tmp_path / f"here_{trial}",
                rng_seed=7 + int(trial.rsplit("_", 1)[-1])), "snv")
            assert _rel(float(metrics["loss"]), here["loss"]) <= 1e-5
    finally:
        torch.set_num_threads(threads)


def test_process_child_without_card_raises(tmp_path):
    """A CUDA run's trial process that finds no card does not train on
    the CPU: it reports the error, and the trial leaves error.txt."""
    from mural_tpu_torch.tune.runner import ExperimentOptions
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    runner.run_experiment(
        dict(CONFIG), loop.TrainOptions("b", "g", device="cuda"), "snv",
        ExperimentOptions(experiment_name="exp", results_dir=str(tmp_path),
                          n_trials=1, epochs=1, trial_executor="process"),
        printer=lambda *a: None)
    (trial,) = _trial_dirs(tmp_path / "exp")
    assert "no CUDA device" in (tmp_path / "exp" / trial /
                                "error.txt").read_text()


def test_seed_device_draws_the_old_masks():
    """Seeding the trial's device (the CPU generator here) draws the
    same dropout masks as the global ``torch.manual_seed`` it replaced,
    and twice in a row the same ones."""
    x = torch.ones(64, 32)
    drop = torch.nn.functional.dropout
    torch.manual_seed(11)
    before = [drop(x, 0.3, training=True) for _ in range(3)]
    for _ in range(2):
        loop.seed_device(torch.device("cpu"), 11)
        after = [drop(x, 0.3, training=True) for _ in range(3)]
        assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_two_serial_trials_draw_the_same_masks(tiny, tmp_path):
    """Two serial runs of one trial seed, dropout on, end bit-identical:
    each run re-seeds its device's generator."""
    fasta, bed = tiny
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = [loop.train_trial(_dropout_config(), _tiny_opts(
            fasta, bed, tmp_path / f"run{i}", rng_seed=5), "snv")
            for i in range(2)]
    finally:
        torch.set_num_threads(threads)
    assert runs[0]["loss"] == runs[1]["loss"]
    a = torch.load(tmp_path / "run0" / "checkpoint_0" / "model")
    b = torch.load(tmp_path / "run1" / "checkpoint_0" / "model")
    assert all(torch.equal(a[k], b[k]) for k in a)
