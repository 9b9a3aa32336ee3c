"""``--trial_ensemble auto`` through the port's experiment runner on the
CPU (counterparts of the runner tests of ``tests/test_ensemble.py``):
the same trial ids, files and losses as serial trials; a member's
checkpoint predicts; an INDEL group; the fall-back to serial trials over
the resident budget; a member stopped by ASHA keeps its weights.  Every
dropout is 0."""
import os

import numpy as np
import pytest
import torch

from mural_tpu_torch.predict.pipeline import PredictOptions, run_predict
from mural_tpu_torch.train.checkpoint import load_config
from mural_tpu_torch.train.loop import TrainOptions
from mural_tpu_torch.tune.runner import ExperimentOptions, run_experiment
from mural_tpu_torch.tune.space import Choice, LogUniform
from test_torch_port_indel_model import one_torch_thread  # noqa: F401

SPACE = dict(
    local_radius=3, local_order=2, local_dropout=0.0,
    distal_fc_dropout=0.0, emb_dropout=0.0, local_hidden1_size=16,
    local_hidden2_size=4, distal_radius=60, segment_center=5000,
    sampled_segments=4, batch_size=32, optim="Adam",
    learning_rate=LogUniform(1e-3, 1e-2), lr_scheduler="StepLR",
    LR_gamma=Choice([0.9, 0.8]), weight_decay=LogUniform(1e-6, 1e-4),
    weight_decay_auto=None, restart_lr=1e-4, min_lr=1e-6,
    CNN_kernel_size=3, CNN_out_channels=4, transfer_learning=False)
FILES = ["checkpoint_0", "checkpoint_1", "progress.csv", "training.log",
         "trial_config.pkl"]


@pytest.fixture(scope="module")
def snv(tmp_path_factory):
    from test_torch_port_tracks import write_genome
    base = tmp_path_factory.mktemp("port_ensemble_runner")
    return write_genome(base, np.random.default_rng(3),
                        {"chr1": 30_000, "chr2": 10_000}, 200)


def _opts(fasta, bed, **kw):
    return TrainOptions(train_data=bed, ref_genome=fasta, n_class=4,
                        model_no=2, valid_ratio=0.25, split_seed=1,
                        device="cpu", **kw)


def _run(base, opts, name, mode, space=SPACE, **kw):
    lines = []
    exp = ExperimentOptions(experiment_name=name, results_dir=str(base),
                            seed=7, ensemble=mode, **kw)
    best = run_experiment(space, opts, "snv", exp,
                          printer=lambda *a: lines.append(" ".join(
                              map(str, a))))
    return best, lines


def test_auto_matches_off(snv, tmp_path):
    """The same experiment seed with ``ensemble`` off and auto: the same
    trial ids and per-trial files, each trial's validation losses within
    5e-3 (the JAX runner test's bound), and the group's lines."""
    fasta, bed = snv
    opts = _opts(fasta, bed)
    runs = {}
    for mode in ("off", "auto"):
        best, lines = _run(tmp_path, opts, f"e_{mode}", mode, n_trials=3,
                           epochs=2, grace_period=3, use_scheduler=True)
        assert len(best) == 3
        exp_dir = tmp_path / f"e_{mode}"
        trials = sorted(d for d in os.listdir(exp_dir)
                        if d.startswith("Train_"))
        for trial in trials:
            assert sorted(os.listdir(exp_dir / trial)) == FILES
            assert sorted(os.listdir(exp_dir / trial / "checkpoint_1")) == [
                "epoch_1_metrics.txt", "model", "model.config.pkl",
                "model.fdiri_cal.pkl"]
            log = (exp_dir / trial / "training.log").read_text()
            assert "Epoch 1 used time" in log and "Best Epoch" in log
        runs[mode] = (trials, {os.path.basename(os.path.dirname(
            os.path.dirname(p))): loss for p, loss in best}, lines)
    (t_off, l_off, _), (t_auto, l_auto, lines) = runs["off"], runs["auto"]
    assert t_off == t_auto and l_off.keys() == l_auto.keys()
    for key in l_off:
        assert abs(l_auto[key] - l_off[key]) <= 5e-3 * abs(l_off[key]), key
    assert any(line.startswith("trial ensemble: 3 members") for line in lines)
    assert any(line.startswith("trial ensemble: shared train arena")
               for line in lines)
    assert sum("finished: loss=" in line for line in lines) == 3


def test_member_checkpoint_predicts(snv, tmp_path):
    """A member's triple loads in ``predict``: its config holds the
    member's sampled values, and the probabilities sum to 1."""
    fasta, bed = snv
    best, _ = _run(tmp_path, _opts(fasta, bed), "ckpt", "auto", n_trials=2,
                   epochs=1, grace_period=2, use_scheduler=True)
    model = best[0][0]
    cfg = load_config(model + ".config.pkl")
    assert "learning_rate" in cfg and "emb_dims" in cfg
    out = run_predict(PredictOptions(
        test_data=bed, ref_genome=fasta, model_path=model,
        model_config_path=model + ".config.pkl",
        calibrator_path=model + ".fdiri_cal.pkl",
        pred_file=str(tmp_path / "pred.tsv.gz"), pred_batch_size=64,
        device="cpu"), "snv", printer=lambda *a: None)
    probs = np.stack([out[f"prob{i}"] for i in range(4)], axis=1)
    assert np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)


def test_indel_group(tmp_path):
    """Two INDEL U-Net trials train as one group: the group line, every
    member's files and finite losses."""
    from test_torch_port_indel_train import write_indel_data
    fasta, bed = write_indel_data(tmp_path, np.random.default_rng(5),
                                  n_sites=480)
    space = dict(
        segment_center=4000, distal_radius=100, CNN_kernel_size=7,
        CNN_out_channels=4, batch_size=32, sampled_segments=2,
        learning_rate=LogUniform(1e-4, 1e-3), optim="Adam",
        lr_scheduler="StepLR", LR_gamma=0.9, weight_decay=1e-5,
        weight_decay_auto=None, restart_lr=1e-4, min_lr=1e-6,
        transfer_learning=False, local_radius=6, local_order=1,
        local_hidden1_size=None, local_hidden2_size=None, emb_dropout=None,
        distal_fc_dropout=None, local_dropout=None, use_reverse=True,
        down_list=[1, 2, 2, 5, 5, 1])
    opts = TrainOptions(train_data=bed, ref_genome=fasta, n_class=8,
                        model_no=0, valid_ratio=0.5, split_seed=0,
                        device="cpu")
    lines = []
    exp = ExperimentOptions(experiment_name="indel", results_dir=str(
        tmp_path), n_trials=2, epochs=1, seed=2, ensemble="auto")
    best = run_experiment(space, opts, "indel", exp,
                          printer=lambda *a: lines.append(" ".join(
                              map(str, a))))
    assert len(best) == 2 and all(np.isfinite(loss) for _, loss in best)
    assert any(line.startswith("trial ensemble: 2 members")
               for line in lines)
    for trial in (tmp_path / "indel").glob("Train_*"):
        assert (trial / "checkpoint_0" / "model").exists()
        assert (trial / "progress.csv").exists()


def test_falls_back_over_the_resident_budget(snv, tmp_path):
    """Data over the resident budget: the group falls back to serial
    trials (no group line), which all finish."""
    fasta, bed = snv
    best, lines = _run(tmp_path, _opts(fasta, bed, resident_max_bytes=1000),
                       "fallback", "auto", n_trials=2, epochs=1)
    assert len(best) == 2
    assert not any("trial ensemble" in line for line in lines)
    assert sum("finished: loss=" in line for line in lines) == 2


def test_stopped_member_keeps_its_weights(snv, tmp_path, monkeypatch):
    """Under ASHA (``use_scheduler``, grace period 1) a member that the
    scheduler stops after an epoch trains no further: the weights of its
    last checkpoint are those of the group's final state, while a live
    member's last checkpoint is a later epoch."""
    import mural_tpu_torch.tune.ensemble as tune_ens
    fasta, bed = snv
    finals = {}
    real = tune_ens.run_ensemble_group

    def spy(*a, **kw):
        import mural_tpu_torch.train.ensemble as ens_mod
        created = []
        init = ens_mod.EnsembleState.__init__

        def record(self, *args, **kwargs):
            init(self, *args, **kwargs)
            created.append(self)

        monkeypatch.setattr(ens_mod.EnsembleState, "__init__", record)
        out = real(*a, **kw)
        finals["ens"] = created[0]
        finals["ids"] = [tid for tid, _ in a[0]]
        return out

    monkeypatch.setattr(tune_ens, "run_ensemble_group", spy)
    space = dict(SPACE, learning_rate=Choice([1e-4, 3e-2]))
    _run(tmp_path, _opts(fasta, bed), "asha", "auto", n_trials=4, epochs=3,
         grace_period=1, use_scheduler=True, space=space)
    ens = finals["ens"]
    exp_dir = tmp_path / "asha"
    last_epochs = []
    for t, tid in enumerate(finals["ids"]):
        epochs = sorted(int(d.split("_")[1]) for d in
                        os.listdir(exp_dir / tid)
                        if d.startswith("checkpoint_"))
        last_epochs.append(epochs[-1])
        saved = torch.load(exp_dir / tid / f"checkpoint_{epochs[-1]}" /
                           "model")
        member = ens.member_state_dict(t)
        for k, v in saved.items():
            assert torch.equal(v, member[k]), (tid, k)
    assert min(last_epochs) < 2 == max(last_epochs)
    assert not bool(ens.live.all())
