"""The port's INDEL training (mural_tpu_torch.train for the U-Net)
against the JAX package on the CPU: three Adam steps against its train
step in float64, one epoch of ``train_trial`` from the same initial
weights, and ``mural_indel train --fused_stem on``, which runs unfused as
in the JAX package.  The U-Net's Dropout(0.1) is turned off on both
sides: Flax and torch draw different masks."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mural_tpu.train.loop as j_loop
import mural_tpu_torch.models.layers as t_layers
from mural_tpu.genome.fasta import decode_sequence
from mural_tpu.models.registry import build_model as j_build_model
from mural_tpu.train import optim as j_optim
from mural_tpu.train.state import create_train_state
from mural_tpu.train.steps import make_train_step
from mural_tpu_torch.cli.mural_indel import main as port_cli
from mural_tpu_torch.models.layers import one_hot_from_codes
from mural_tpu_torch.models.registry import build_model
from mural_tpu_torch.ops import fused_train_stem as fts
from mural_tpu_torch.train import loop
from mural_tpu_torch.train.optim import LRSchedule, build_optimizer
from mural_tpu_torch.train.steps import TrainState, train_step
from mural_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_indel_model import (no_jax_dropout,  # noqa: F401
                                          one_torch_thread)
from test_torch_port_train import _rel
from test_torch_port_train_trial import _trial_files

# the tiny INDEL config of tests/test_end_to_end.py (test_indel_train_small)
CONFIG = dict(
    local_radius=3, local_order=1, local_dropout=0.1,
    distal_fc_dropout=0.1, emb_dropout=0.1,
    local_hidden1_size=8, local_hidden2_size=4,
    distal_radius=100, segment_center=4000, sampled_segments=4,
    batch_size=16, optim="AdamW", learning_rate=1e-3,
    lr_scheduler="StepLR2", LR_gamma=0.98, weight_decay=0.01,
    weight_decay_auto=None, restart_lr=1e-4, min_lr=1e-6,
    CNN_kernel_size=7, CNN_out_channels=4,
    down_list=[1, 2, 2, 5, 5, 1], use_reverse=True,
    transfer_learning=False,
)


def write_indel_data(base, rng, n_sites=960):
    """A FASTA (two chromosomes with N runs) and a sorted INDEL BED whose
    labels cycle over 0..7 along it, on both strands, so that every run of
    8 sites (and so every validation segment and evaluation region) holds
    each class; sites keep a window's distance from the ends but their
    windows may reach an N run."""
    fasta, bed = base / "seq.fa", base / "indel.bed"
    rows = []
    with open(fasta, "w") as fh:
        for chrom, n, k in (("chr1", 40_000, n_sites * 3 // 4),
                            ("chr2", 12_000, n_sites - n_sites * 3 // 4)):
            codes = rng.integers(0, 4, size=n).astype(np.uint8)
            codes[rng.integers(0, n, size=n // 200)] = 14
            fh.write(f">{chrom}\n{decode_sequence(codes)}\n")
            pos = np.sort(rng.choice(np.arange(200, n - 200), size=k,
                                     replace=False))
            rows += [(chrom, int(p)) for p in pos]
    with open(bed, "w") as fh:
        for i, (chrom, p) in enumerate(rows):
            fh.write(f"{chrom}\t{p}\t{p + 1}\t.\t{i % 8}\t"
                     f"{'+-'[i // 8 % 2]}\n")
    return str(fasta), str(bed)


# the learning rate of the epoch's parity run: at 1e-3 the two float32
# trajectories drift apart chaotically, beyond the loss tolerance, as in
# tests/test_torch_port_train_trial.py
LR = 1e-4
# per-step train loss, port against the JAX package in float64 (torch's
# clip_grad_norm_ adds 1e-6 to the norm, optax's clip does not: when it
# fires, the updates differ by ~1e-7 relative)
STEP_TOL = 1e-4
STEP_TOL64 = 1e-6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_indel_train")
    return (base,) + write_indel_data(base, np.random.default_rng(5))


def _genome_like(rng, B, W):
    """(B, W) codes of A, C, G and T with 1% N."""
    codes = rng.integers(0, 4, size=(B, W)).astype(np.uint8)
    codes[rng.random((B, W)) < 0.01] = 14
    return codes


def test_train_steps_match_jax_step(no_jax_dropout):
    """Three Adam steps of the port against the JAX package's train step
    run in float64, on the same weights and batches: the learning rate
    within 1e-6, per-step loss within STEP_TOL64 for the port in float64
    and within STEP_TOL for the port in float32.  The JAX side is
    ``make_train_step``: its packed single step holds float32 leaves
    only, and the JAX package's float32 train forward of this U-Net
    stands further from its float64 one than the tolerance (its
    single-pass BN variance, tests/test_torch_port_indel_model.py)."""
    rng = np.random.default_rng(41)
    B, steps, W = 16, 3, 2 * CONFIG["distal_radius"]
    common = {"emb_dims": [(4, 1)] * 6, "n_cont": 0, "n_class": 8,
              "distal_order": 1, "in_channels": 4}
    batches = [(rng.integers(0, 8, size=B), rng.integers(0, 4, size=(B, 6)),
                _genome_like(rng, B, W)) for _ in range(steps)]
    schedule_args = ("StepLR", 1e-3, 0.9, B, steps * B * 2, 1e-4, 1e-6)

    class _DS:
        cat = np.zeros((2, 6), np.int32)
        n_cont = 0
        distal_width = W
        n_distal_tracks = 0

    with jax.enable_x64(True):
        jmodel = j_build_model(0, CONFIG, common, "indel")
        variables = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64),
            j_loop._init_variables(jmodel, _DS(), 4))
        jstate = create_train_state(jmodel, variables, "Adam", 1e-5,
                                    j_optim.LRSchedule.build(*schedule_args))
        jstep = make_train_step(jmodel, donate=False)
        jlosses = []
        for y, cat, codes in batches:
            jstate, jloss, jlr = jstep(
                jstate, jnp.asarray(y, jnp.int32), jnp.asarray(cat, jnp.int32),
                None, jnp.asarray(codes), jnp.ones((B,), jnp.float64),
                jax.random.key(0))
            jlosses.append((float(jloss), float(jlr)))
        host = jax.tree.map(np.asarray, variables)

    for dtype, tol in ((torch.float64, STEP_TOL64),
                       (torch.float32, STEP_TOL)):
        model = build_model(0, CONFIG, common, "indel").to(dtype)
        model.load_state_dict(state_dict_from_jax(host, model), strict=True)
        model.out_fc[1].p = 0.0
        state = TrainState(model, build_optimizer(
            "Adam", model.parameters(), 1e-5),
            LRSchedule.build(*schedule_args))
        for i, ((y, cat, codes), (jloss, jlr)) in enumerate(
                zip(batches, jlosses)):
            loss, lr = train_step(
                state, torch.from_numpy(y).long(),
                torch.from_numpy(cat).long(),
                one_hot_from_codes(torch.from_numpy(codes), dtype),
                torch.ones(B, dtype=dtype))
            assert _rel(lr, jlr) <= 1e-6
            assert _rel(float(loss), jloss) <= tol, (dtype, i)


def test_train_trial_one_epoch_matches_jax(data, monkeypatch,
                                           no_jax_dropout):
    """One epoch of the port's train_trial for INDEL against the JAX
    package's host-fed single-step train_trial, from the same initial
    weights (the port's init is patched to load the JAX init through the
    weight bridge): loss, fdiri_loss and score, the trial's files and the
    saved config."""
    base, fasta, bed = data
    captured = {}
    j_init = j_loop._init_variables

    def capture(model, ds, seed):
        captured["v"] = jax.tree.map(np.asarray, j_init(model, ds, seed))
        return captured["v"]

    monkeypatch.setattr(j_loop, "_init_variables", capture)
    common = dict(train_data=bed, ref_genome=fasta, epochs=1, n_class=8,
                  model_no=0, valid_ratio=0.5, split_seed=0, rng_seed=1)
    jdir, tdir = str(base / "jax_trial"), str(base / "port_trial")
    config = dict(CONFIG, learning_rate=LR)
    jm = j_loop.train_trial(config, j_loop.TrainOptions(
        trial_dir=jdir, resident="off", steps_per_dispatch=1, **common),
        "indel")

    def load_jax_init(model, ds, seed):
        model.load_state_dict(state_dict_from_jax(captured["v"], model),
                              strict=True)
        model.out_fc[1].p = 0.0
        return model

    monkeypatch.setattr(loop, "init_model", load_jax_init)
    tm = loop.train_trial(config, loop.TrainOptions(
        trial_dir=tdir, device="cpu", **common), "indel")
    assert _rel(tm["loss"], jm["loss"]) <= 1e-4
    assert _rel(tm["fdiri_loss"], jm["fdiri_loss"]) <= 1e-3
    assert _rel(tm["score"], jm["score"]) <= 1e-4
    assert np.isfinite(tm["score"])
    assert tm["total_params"] == jm["total_params"]
    assert _trial_files(tdir) == _trial_files(jdir)
    saved = []
    for trial_dir in (tdir, jdir):
        with open(os.path.join(trial_dir, "checkpoint_0",
                               "model.config.pkl"), "rb") as fh:
            saved.append(pickle.load(fh))
    assert saved[0] == saved[1]


def test_cli_fused_stem_on_runs_unfused(data, monkeypatch, capsys):
    """``mural_indel train --fused_stem on`` trains the U-Net on the
    one-hot, as the JAX package does: the fused stem is never called
    and K2 never launched."""
    base, fasta, bed = data
    monkeypatch.chdir(base)
    calls = []
    stem = t_layers.code_conv_pool
    monkeypatch.setattr(t_layers, "code_conv_pool",
                        lambda *a: calls.append(1) or stem(*a))
    fts.FWD_LAUNCHES = fts.BWD_LAUNCHES = 0
    assert port_cli(["train", "--cpu_only", "--ref_genome", fasta,
                     "--train_data", bed, "--experiment_name", "fused_on",
                     "--n_trials", "1", "--epochs", "1", "--valid_ratio",
                     "0.5", "--split_seed", "0", "--fused_stem", "on",
                     "--distal_radius", "100", "--down_list", "1", "2",
                     "2", "5", "5", "1", "--CNN_out_channels", "4",
                     "--batch_size", "32", "--segment_center", "4000"]) == 0
    assert "fused train stem" not in capsys.readouterr().out
    assert calls == [] and fts.FWD_LAUNCHES == fts.BWD_LAUNCHES == 0
    (trial,) = [d for d in os.listdir(base / "results" / "fused_on")
                if d.startswith("Train_")]
    ck = base / "results" / "fused_on" / trial / "checkpoint_0"
    assert sorted(os.listdir(ck)) == ["epoch_0_metrics.txt", "model",
                                      "model.config.pkl",
                                      "model.fdiri_cal.pkl"]
