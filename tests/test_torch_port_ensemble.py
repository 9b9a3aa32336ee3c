"""Trial ensembles (``mural_tpu_torch/train/ensemble.py``) on the CPU:
each member's step scalars from its own schedule; the stacked update
against ``GraphOptimizer``; an ensemble epoch against each member's
serial resident trial in the port and against the JAX package's
ensemble on the same weights and rows; bf16 members against serial bf16
trials; the ``live`` mask; the runner's grouping rules against the JAX
package's.  Every dropout is 0 (members draw their masks from the
device generator, serial trials theirs).  The runner's end-to-end
tests are in ``test_torch_port_ensemble_runner.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mural_tpu.train.loop as j_loop
from mural_tpu.models.registry import build_model as j_build_model
from mural_tpu.train import ensemble as j_ens
from mural_tpu.train import optim as j_optim
from mural_tpu.train import resident as j_res
from mural_tpu.tune import ensemble as j_tune
from mural_tpu_torch.models.registry import build_model
from mural_tpu_torch.train import resident
from mural_tpu_torch.train.ensemble import (EnsembleOptimizer,
                                            EnsembleState, ensemble_batch,
                                            ensemble_epoch_scalars,
                                            ensemble_eval,
                                            ensemble_step_update)
from mural_tpu_torch.train.graphs import StepGroups, epoch_scalars
from mural_tpu_torch.train.loop import TrainOptions
from mural_tpu_torch.train.optim import GraphOptimizer, LRSchedule
from mural_tpu_torch.train.steps import GRAD_CLIP, TrainState
from mural_tpu_torch.tune import ensemble as tune
from mural_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_indel_model import one_torch_thread  # noqa: F401
from test_torch_port_resident import KW, SEGMENTS, dsets  # noqa: F401
from test_torch_port_resident import data  # noqa: F401
from test_torch_port_train import CONFIG, _rel

B, T, K = 32, 3, 4
# members differing in learning rate, weight decay, gamma and seed
LRS, WDS, GAMMAS, SEEDS = [5e-3, 1e-3, 2e-2], [0.0, 1e-4, 1e-2], \
    [0.9, 0.5, 0.99], [0, 1, 2]
# a member's epoch loss and validation against its serial trial's, and
# against the JAX ensemble's (relative)
TOL = 1e-4


def _schedules(kind, n_sites, lrs=LRS, gammas=GAMMAS):
    return [LRSchedule.build(kind, lr, g, B, n_sites, 1e-4, 1e-6)
            for lr, g in zip(lrs, gammas)]


@pytest.mark.parametrize("kind", ["StepLR", "StepLR2", "constant"])
def test_member_scalars_follow_their_schedules(kind):
    """Row ``(i, t)``: member t's LR of step ``step + i`` from its own
    schedule (equal to the JAX package's ``LRSchedule.lr_at`` within
    float32) and GraphOptimizer's scalars at its weight decay."""
    params = [(1e-2, 0.5, 1e-3, 1e-5), (5e-3, 0.9, 1e-4, 1e-6),
              (2e-3, 0.3, 5e-4, 2e-4)]      # fast decay: restarts soon
    args = [(kind, lr, g, 32, 4096, r, m) for lr, g, r, m in params]
    model = torch.nn.Linear(3, 2)
    stacked = {"w": torch.zeros(3, 4)}
    for name in ("Adam", "AdamW2", "SGD"):
        ens = type("E", (), {})()
        ens.optimizer = EnsembleOptimizer(name, stacked, WDS)
        ens.schedules = [LRSchedule.build(*a) for a in args]
        ens.rop_lr = [s.base_lr for s in ens.schedules]
        ens.n_members, ens.step, ens.epoch = 3, 150, 1
        rows = ensemble_epoch_scalars(ens, 40)
        assert rows.shape == (40, 3, 4) and rows.dtype == np.float32
        for t, a in enumerate(args):
            state = TrainState(model, GraphOptimizer(
                name, model.parameters(), WDS[t]), LRSchedule.build(*a))
            state.step, state.epoch = 150, 1
            np.testing.assert_array_equal(rows[:, t],
                                          epoch_scalars(state, 40))
            jsched = j_optim.LRSchedule.build(*a)
            for i in (0, 7, 39):
                want = float(jsched.lr_at(jnp.asarray(150 + i),
                                          jnp.asarray(1)))
                assert _rel(float(rows[i, t, 0]), want) <= 1e-5


@pytest.mark.parametrize("optim", ["Adam", "AdamW2", "SGD"])
def test_update_matches_graph_optimizer(optim):
    """Six steps of the stacked update (clip to 10, then GraphOptimizer's
    formulas at each member's scalars and weight decay) against each
    member's ``clip_grad_norm_`` + ``GraphOptimizer``, with clipped and
    unclipped gradients in turn: within 1e-6 of each tensor's scale."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 2, 4)}
    members = [{k: torch.nn.Parameter(torch.from_numpy(
        rng.normal(0, 0.1, s).astype(np.float32))) for k, s in
        shapes.items()} for _ in range(T)]
    stacked = {k: torch.stack([m[k].detach() for m in members])
               for k in shapes}
    opt = EnsembleOptimizer(optim, stacked, WDS)
    serial = [GraphOptimizer(optim, list(m.values()), WDS[t])
              for t, m in enumerate(members)]
    for step in range(6):
        scale = 5.0 if step % 2 else 0.1
        grads = {k: torch.from_numpy(rng.normal(0, scale, (T, *s))
                                     .astype(np.float32))
                 for k, s in shapes.items()}
        for t, m in enumerate(members):
            lr = LRS[t] * 0.9 ** step
            row = serial[t].step_scalars(lr, step + 1)
            assert row == opt.step_scalars(t, lr, step + 1)
            opt.scalars[t] = torch.tensor(row)
            serial[t].scalars.copy_(torch.tensor(row))
            for k, p in m.items():
                p.grad = grads[k][t].clone()
            torch.nn.utils.clip_grad_norm_(list(m.values()), GRAD_CLIP)
            serial[t].step()
        opt.step(grads)
        for t, m in enumerate(members):
            for k, p in m.items():
                assert ((stacked[k][t] - p).abs().max()
                        <= 1e-6 * p.abs().max()), (step, t, k)


def _port_models(ds, jds, seeds):
    """(JAX SNVNet2, its per-seed inits, the port's models holding the
    same weights) at CONFIG's widths, dropout 0."""
    n_cat = ds.cat.shape[1]
    common = {"emb_dims": [(17, 2)] * n_cat, "n_cont": 0, "n_class": 4,
              "distal_order": 1, "in_channels": 4}
    jmodel = j_build_model(2, CONFIG, common, "snv")

    class _DS:
        cat = np.zeros((2, n_cat), np.int32)
        n_cont = 0
        distal_width = ds.distal_width
        n_distal_tracks = 0

    variables = [j_loop._init_variables(jmodel, _DS(), s) for s in seeds]
    models = []
    for v in variables:
        model = build_model(2, CONFIG, common, "snv")
        model.load_state_dict(state_dict_from_jax(
            jax.tree.map(np.asarray, v), model), strict=True)
        models.append(model)
    return jmodel, variables, models


def _rows(ds, n):
    """Each member's epoch rows from its own generator: (steps, n, B)."""
    return np.stack([resident.stack_epoch_rows(
        ds, SEGMENTS, B, True, np.random.default_rng(100 + t))[0]
        for t in range(n)], axis=1)


def _ensemble_epoch(models, optim, res, rows, schedules, wds, bf16=False,
                    k=K):
    ens = EnsembleState(models, optim, wds, schedules, bf16=bf16)
    groups = StepGroups(ens, k, ensemble_batch(res, torch.ones(B)),
                        ensemble_step_update)
    losses = resident.resident_epoch(groups, torch.from_numpy(rows).long(),
                                     torch.from_numpy(ensemble_epoch_scalars(
                                         ens, len(rows))))
    return ens, losses


def _serial_epoch(model, optim, res, rows, schedule, wd, bf16=False):
    state = TrainState(model, GraphOptimizer(optim, model.parameters(), wd),
                       schedule, bf16=bf16)
    groups = StepGroups(state, K, resident.resident_batch(
        res, False, torch.ones(B)))
    return resident.resident_epoch(groups, torch.from_numpy(rows).long(),
                                   torch.from_numpy(epoch_scalars(
                                       state, len(rows))))


@pytest.mark.parametrize("optim", ["Adam", "AdamW2", "SGD"])
def test_ensemble_epoch_matches_serial_resident(dsets, optim):  # noqa: F811
    """One epoch of T=3 members (in groups of 4 steps) against each
    member's serial resident trial on its rows, with the JAX package's
    checks (``tests/test_ensemble.py``): epoch losses within 1e-4; the
    vmapped validation (``ensemble_eval``) against ``resident_eval`` of a
    model holding the member's trained weights within 1e-4; the trained
    member's validation loss within 5e-3 of its serial trial's.  Each
    step's loss stays within 1e-3: the SGD member at LR 2e-2 sits at a
    near-tie of a max pool, where vmap's summation order moves one step's
    loss by 9.4e-4, as a 1e-7 relative perturbation of the serial
    trial's own initial weights does.  With SGD each member's BatchNorm
    running buffers are within 1e-4 of their serial trial's (of each
    buffer's scale; they come out within 4e-6); as in the JAX test,
    Adam's are not held one by one, nor are parameters: Adam turns the
    rounding noise of a gradient that is zero in exact arithmetic (a
    bias feeding a BatchNorm) into steps of the learning rate, which
    moves the next BatchNorm's running mean."""
    ds, jds = dsets["snv"]
    _, _, models = _port_models(ds, jds, SEEDS)
    _, _, serial = _port_models(ds, jds, SEEDS)
    _, _, holder = _port_models(ds, jds, SEEDS[:1])
    res = resident.make_resident(ds, "cpu")
    rows = _rows(ds, T)
    schedules = _schedules("StepLR", ds.n_sites)
    ens, losses = _ensemble_epoch(models, optim, res, rows, schedules, WDS)
    assert losses.shape == (len(rows), T) and ens.step == len(rows)
    vrows, vmasks, _ = resident.stack_epoch_rows(ds, SEGMENTS, B, False,
                                                 pad_final=True)
    vrows = torch.from_numpy(vrows.astype(np.int64))
    vmasks = torch.from_numpy(vmasks)
    logits, vloss = ensemble_eval(ens, res, vrows, vmasks)
    assert logits.shape[:2] == (T, len(vrows))
    for t in range(T):
        want = _serial_epoch(serial[t], optim, res, rows[:, t],
                             schedules[t], WDS[t])
        assert _rel(float(losses[:, t].sum()), float(want.sum())) <= TOL
        for a, b in zip(losses[:, t].tolist(), want.tolist()):
            assert _rel(a, b) <= 1e-3
        member = ens.member_state_dict(t)
        for k, b in serial[t].named_buffers():
            if optim == "SGD" and b.dtype.is_floating_point:
                assert ((member[k] - b).abs().max()
                        <= TOL * max(float(b.abs().max()), 1e-3)), k
        holder[0].load_state_dict(ens.member_state_dict(t))
        lg, vl = resident.resident_eval(holder[0], res, vrows, vmasks,
                                        False)
        assert _rel(float(vloss[t]), float(vl)) <= TOL
        assert (logits[t] - lg).abs().max() <= TOL * lg.abs().max()
        _, vl_serial = resident.resident_eval(serial[t], res, vrows, vmasks,
                                              False)
        assert _rel(float(vloss[t]), float(vl_serial)) <= 5e-3


def test_ensemble_epoch_matches_jax_ensemble(dsets):  # noqa: F811
    """The port's ensemble epoch (T=2, Adam, members differing in LR,
    weight decay and seed) against the JAX package's
    ``make_ensemble_epoch_fn`` on the same weights and rows: each
    member's epoch loss within 1e-4 relative (the port's step tests'
    tolerance; both float32 over one short epoch)."""
    ds, jds = dsets["snv"]
    seeds = SEEDS[:2]
    jmodel, variables, models = _port_models(ds, jds, seeds)
    rows = _rows(ds, 2)
    schedules = _schedules("StepLR", ds.n_sites, LRS[:2], GAMMAS[:2])
    _, losses = _ensemble_epoch(models, "Adam", resident.make_resident(
        ds, "cpu"), rows, schedules, WDS[:2])
    jscheds = [j_optim.LRSchedule.build("StepLR", lr, g, B, ds.n_sites,
                                        1e-4, 1e-6)
               for lr, g in zip(LRS[:2], GAMMAS[:2])]
    jens = j_ens.create_ensemble_state(variables, "Adam", WDS[:2], jscheds,
                                       seeds)
    epoch_fn = j_ens.make_ensemble_epoch_fn(jmodel, jens, ds.distal_width)
    jres = j_res.make_resident(jds)
    _, jlosses = epoch_fn(jens, jres.arena, jres.y, jres.cat, jres.cont,
                          jres.astart, jres.neg,
                          jnp.asarray(rows.transpose(1, 0, 2)))
    for a, b in zip(losses.sum(0).tolist(), np.asarray(jlosses).tolist()):
        assert _rel(a, b) <= TOL


def test_bf16_ensemble_matches_serial_bf16(dsets):  # noqa: F811
    """bf16 members (T=2, Adam) against their serial resident bf16
    trials: epoch losses within 5e-3 relative, the JAX package's bound
    for the same comparison (``tests/test_ensemble.py``): the vmapped
    BatchNorm normalises in float32 from the bfloat16 input, the serial
    one inside its mixed-dtype kernel, and vmap sums in another order;
    parameters and buffers stay float32."""
    ds, jds = dsets["snv"]
    seeds = SEEDS[:2]
    _, _, models = _port_models(ds, jds, seeds)
    _, _, serial = _port_models(ds, jds, seeds)
    res = resident.make_resident(ds, "cpu")
    rows = _rows(ds, 2)
    schedules = _schedules("StepLR", ds.n_sites, LRS[:2], GAMMAS[:2])
    ens, losses = _ensemble_epoch(models, "Adam", res, rows, schedules,
                                  [0.0, 0.0], bf16=True)
    assert torch.isfinite(losses).all()
    for t in range(2):
        want = _serial_epoch(serial[t], "Adam", res, rows[:, t],
                             schedules[t], 0.0, bf16=True)
        assert _rel(float(losses[:, t].sum()), float(want.sum())) <= 5e-3
    for k, v in (*ens.params.items(), *ens.buffers.items()):
        assert v.dtype == (torch.int64 if "num_batches" in k
                           else torch.float32), k


def test_live_mask_freezes_a_member(dsets):  # noqa: F811
    """A member whose ``live`` is False keeps its parameters, optimizer
    state and BN buffers through an epoch while the other trains."""
    ds, jds = dsets["snv"]
    _, _, models = _port_models(ds, jds, SEEDS[:2])
    res = resident.make_resident(ds, "cpu")
    ens = EnsembleState(models, "Adam", [0.0, 0.0],
                        _schedules("StepLR", ds.n_sites, LRS[:2],
                                   GAMMAS[:2]))
    ens.live[1] = False
    before = {k: v.clone() for k, v in ens.member_state_dict(1).items()}
    live_before = {k: v.clone() for k, v in ens.member_state_dict(0).items()}
    rows = torch.from_numpy(_rows(ds, 2)).long()
    groups = StepGroups(ens, K, ensemble_batch(res, torch.ones(B)),
                        ensemble_step_update)
    losses = resident.resident_epoch(groups, rows, torch.from_numpy(
        ensemble_epoch_scalars(ens, len(rows))))
    assert torch.isfinite(losses).all()
    after = ens.member_state_dict(1)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    for state in ens.optimizer.state.values():
        for v in state.values():
            assert not v[1].any()
    moved = ens.member_state_dict(0)
    assert not torch.equal(moved["conv1.1.weight"],
                           live_before["conv1.1.weight"])


def test_group_signature_and_eligibility_match_jax():
    """``group_signature``, ``group_trials`` and ``ensemble_eligible``
    decide as the JAX package's on the same configs and options."""
    from mural_tpu.train.loop import TrainOptions as JTrainOptions
    base = dict(batch_size=32, optim="Adam", learning_rate=1e-3,
                weight_decay=0.0, LR_gamma=0.9, CNN_out_channels=8,
                transfer_learning=False, sampled_segments=10)
    configs = [base, dict(base, learning_rate=5e-3, weight_decay=1e-4,
                          sampled_segments=5, LR_gamma=0.8, min_lr=1e-7),
               dict(base, batch_size=64), dict(base, optim="SGD"),
               dict(base, CNN_out_channels=16)]
    trials = [(f"t{i}", c) for i, c in enumerate(configs)]
    assert ([[t for t, _ in g] for g in tune.group_trials(trials)]
            == [[t for t, _ in g] for g in j_tune.group_trials(trials)]
            == [["t0", "t1"], ["t2"], ["t3"], ["t4"]])
    for a in configs:
        for b in configs:
            assert ((tune.group_signature(a) == tune.group_signature(b))
                    == (j_tune.group_signature(a)
                        == j_tune.group_signature(b)))
    assert tune.VARY_KEYS == j_tune.VARY_KEYS
    opts = TrainOptions(train_data="x", ref_genome="y")
    jopts = JTrainOptions(train_data="x", ref_genome="y")
    cases = [({}, base), ({}, dict(base, transfer_learning=True)),
             ({"resident": "off"}, base), ({"dp_devices": 2}, base),
             ({"profile_dir": "p"}, base), ({"model_path": "m"}, base),
             ({"resident": "on"}, base)]
    for change, cfg in cases:
        got = tune.ensemble_eligible(cfg, dataclasses.replace(opts,
                                                              **change))
        want = j_tune.ensemble_eligible(cfg, dataclasses.replace(jopts,
                                                                 **change))
        assert got == want, change
    assert tune.ensemble_eligible(base, opts)
