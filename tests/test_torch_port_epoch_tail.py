"""The overlapped epoch tail of the port's ``train_trial`` (calibration,
evaluation, checkpoint and the runner's report on a thread while the
next epoch trains) against the JAX package's on the CPU: a report that
stops the trial at epoch 0 leaves the same files on both feeds, an error
in the tail reaches the caller, and early stopping ends at the same
epoch.  Every dropout is 0."""
import os

import numpy as np
import pytest

import mural_tpu.train.loop as j_loop
from mural_tpu_torch.train import loop
from test_torch_port_indel_model import one_torch_thread  # noqa: F401
from test_torch_port_train import CONFIG
from test_torch_port_train_trial import _trial_files, _write_data


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_epoch_tail")
    return (base,) + _write_data(base, np.random.default_rng(3))


def _progress(trial_dir):
    with open(os.path.join(trial_dir, "progress.csv")) as fh:
        rows = [line.rstrip("\n").split(",") for line in fh]
    return rows[0], [r[0] for r in rows[1:]]


@pytest.mark.parametrize("resident", ["on", "off"])
def test_scheduler_stop_at_epoch_0_matches_jax(data, resident):
    """``report_fn`` returns False at epoch 0 of 3: whether the next
    epoch starts before the tail reports or not, both packages stop with
    checkpoint_0 alone, one metrics file and a one-row ``progress.csv``
    of the same columns; the hook saw one report."""
    base, fasta, bed = data
    common = dict(train_data=bed, ref_genome=fasta, epochs=3,
                  valid_ratio=0.5, split_seed=0, rng_seed=1,
                  resident=resident)
    seen = {"jax": [], "port": []}

    def stop(key):
        def report(metrics):
            seen[key].append(metrics["epoch"])
            return False
        return report

    jdir, tdir = (str(base / f"{k}_stop_{resident}") for k in seen)
    j_loop.train_trial(dict(CONFIG), j_loop.TrainOptions(
        trial_dir=jdir, **common), "snv", report_fn=stop("jax"))
    loop.train_trial(dict(CONFIG), loop.TrainOptions(
        trial_dir=tdir, device="cpu", **common), "snv",
        report_fn=stop("port"))
    assert seen["port"] == seen["jax"] == [0]
    assert _trial_files(tdir) == _trial_files(jdir)
    assert sorted(os.listdir(tdir)) == ["checkpoint_0", "progress.csv"]
    assert _progress(tdir) == _progress(jdir)
    assert _progress(tdir)[1] == ["0"]


def test_tail_thread_order():
    """``TailThread``: one tail at a time; a False return sets ``stop``;
    an error sets it too and is raised by the next ``join`` only once."""
    import threading
    gate, seen = threading.Event(), []

    def report_stop():
        assert gate.wait(10)
        seen.append("first")
        return False

    tail = loop.TailThread()
    tail.start(report_stop)
    assert not tail.stop
    gate.set()
    tail.join()
    assert seen == ["first"] and tail.stop and tail.thread is None
    tail = loop.TailThread()
    tail.start(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        tail.join()
    assert tail.stop
    tail.join()                            # raised once


def test_tail_error_reaches_the_caller(data, monkeypatch):
    """An exception in epoch 0's tail is raised by ``train_trial`` (at
    the join after epoch 1's validation), and no later tail starts."""
    base, fasta, bed = data
    calls = []

    def failing_tail(self, epoch, *args):
        calls.append(epoch)
        raise KeyError("tail failed at epoch 0")

    monkeypatch.setattr(loop.EpochTail, "__call__", failing_tail)
    with pytest.raises(KeyError, match="tail failed at epoch 0"):
        loop.train_trial(dict(CONFIG), loop.TrainOptions(
            train_data=bed, ref_genome=fasta, epochs=3, valid_ratio=0.5,
            split_seed=0, rng_seed=1, device="cpu",
            trial_dir=str(base / "failing")), "snv")
    assert calls == [0]


# validation losses each package's EarlyStopping sees, epoch by epoch:
# with patience 2 the trial stops after epoch 3, whose tail still runs,
# and the best epoch is 1
SCRIPTED_LOSSES = (1.0, 0.9, 0.95, 0.97, 0.5)


def _scripted(cls):
    """``cls`` (a package's EarlyStopping) fed SCRIPTED_LOSSES: the two
    trainers' float32 trajectories part at any rate where the validation
    loss turns, so each stop decision gets the same losses."""
    class Scripted(cls):
        def __call__(self, val_loss):
            self.seen = getattr(self, "seen", 0) + 1
            return super().__call__(SCRIPTED_LOSSES[self.seen - 1])
    return Scripted


def test_early_stopping_ends_at_jax_epoch(data, monkeypatch):
    """Patience 2 on the same scripted validation losses: both packages
    stop at the same epoch, after its tail wrote its checkpoint, with the
    same files, ``progress.csv`` and best epoch."""
    base, fasta, bed = data
    monkeypatch.setattr(j_loop, "EarlyStopping",
                        _scripted(j_loop.EarlyStopping))
    monkeypatch.setattr(loop, "EarlyStopping",
                        _scripted(loop.EarlyStopping))
    common = dict(train_data=bed, ref_genome=fasta, epochs=5,
                  valid_ratio=0.5, split_seed=0, rng_seed=1,
                  grace_period=2)
    jdir, tdir = str(base / "jax_es"), str(base / "port_es")
    jm = j_loop.train_trial(dict(CONFIG), j_loop.TrainOptions(
        trial_dir=jdir, **common), "snv")
    tm = loop.train_trial(dict(CONFIG), loop.TrainOptions(
        trial_dir=tdir, device="cpu", **common), "snv")
    assert tm["epoch"] == jm["epoch"] == 3
    assert tm["best_epoch"] == jm["best_epoch"] == 1
    assert _trial_files(tdir) == _trial_files(jdir)
    assert _progress(tdir) == _progress(jdir)
    assert _progress(tdir)[1] == ["0", "1", "2", "3"]
