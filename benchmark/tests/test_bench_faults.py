"""A run with the timed path broken underneath comes out not correct: the
rest of a run (set-up, window, comparison) driven at tiny sizes, past
the harness's look for a card, with one fault planted in the measured
program.  Those marked ``chip`` run the train cell's CUDA graph replays
on the card (on the CPU every group is eager) and skip without it."""

import time

import numpy as np
import pytest
import torch

from harness import checks as ck
from harness import spec
import tiny


def _run(name, seconds=0.5, device=torch.device("cpu"), **traffic):
    cell = tiny.cell(name, **traffic)
    if device.type == "cuda":
        # replays are fast on the card: an epoch that outlasts the window
        cell.config.update(train_sites=40000, train_genome_bases=400000)
    # the tiny cells' limits: the cell's own
    out = spec.load_module("runners", cell.traffic["runner"]).run(
        cell, 20260418, seconds, False, device, time.time())
    return out, ck.all_ok(out.checks) and out.failed == 0


def _failed(out):
    return {c.name for c in out.checks if not c.ok}


@pytest.mark.parametrize("name", ["snv_hs.train", "indel_hs.train"])
def test_sound_train_run_is_correct(name):
    out, correct = _run(name)
    assert correct, [c for c in out.checks if not c.ok]


def test_unchanged_state_is_caught(monkeypatch):
    from mural_tpu_torch.train import optim
    monkeypatch.setattr(optim.GraphOptimizer, "step", lambda self: None)
    out, correct = _run("snv_hs.train")
    assert not correct
    assert _failed(out) >= {"change_median_gap", "group_change_gap"}


def test_full_group_update_left_out_is_caught(monkeypatch):
    """The update left out of whole groups of K steps only, the path that
    replays the graph on the card; steps 1-3 (shorter groups) stay
    sound, so only the group after the window can see it."""
    from mural_tpu_torch.train import graphs, optim
    real_run, real_step = graphs.run_steps, optim.GraphOptimizer.step
    whole = []

    def run_steps(state, scalars, *args, **kw):
        whole.append(scalars.shape[0] > 1)
        try:
            return real_run(state, scalars, *args, **kw)
        finally:
            whole.pop()

    def step(self):
        if not (whole and whole[-1]):
            real_step(self)

    monkeypatch.setattr(graphs, "run_steps", run_steps)
    monkeypatch.setattr(optim.GraphOptimizer, "step", step)
    out, correct = _run("snv_hs.train")
    assert not correct
    assert "group_change_gap" in _failed(out)
    assert not _failed(out) & {"loss_gap", "change_median_gap"}


@pytest.mark.chip
def test_sound_replayed_train_run_is_correct(card):
    out, correct = _run("snv_hs.train", seconds=0.2, device=card)
    assert correct, [c for c in out.checks if not c.ok]


@pytest.mark.chip
def test_update_left_out_of_the_graph_is_caught(card, monkeypatch):
    """The optimizer's update left out while the graph is captured only:
    eager steps update, every replay leaves the parameters as they were."""
    from mural_tpu_torch.train import optim
    real_step = optim.GraphOptimizer.step

    def step(self):
        if not torch.cuda.is_current_stream_capturing():
            real_step(self)

    monkeypatch.setattr(optim.GraphOptimizer, "step", step)
    out, correct = _run("snv_hs.train", seconds=0.2, device=card)
    assert not correct
    assert "group_change_gap" in _failed(out)
    assert not _failed(out) & {"loss_gap", "change_median_gap"}


@pytest.mark.chip
def test_scalars_baked_into_the_graph_are_caught(card, monkeypatch):
    """Each replay runs at the LR and bias corrections of the steps it was
    captured at: the new scalars are not copied in."""
    from mural_tpu_torch.train import graphs

    def replay(self, scalars, inputs):
        for static, t in zip(self.static, inputs):
            if static is not None:
                static.copy_(t)
        self.graph.replay()
        return self.static_losses.clone()

    monkeypatch.setattr(graphs.StepGroups, "_replay", replay)
    out, correct = _run("snv_hs.train", seconds=0.2, device=card)
    assert not correct
    assert "group_change_gap" in _failed(out)


def test_half_batch_is_caught(monkeypatch):
    """The loss taken over half of each batch, scaled to the whole."""
    from mural_tpu_torch.train import steps
    ce = steps.masked_ce_sum

    def half(logits, y, mask):
        h = len(y) // 2
        return 2 * ce(logits[:h], y[:h], mask[:h])

    monkeypatch.setattr(steps, "masked_ce_sum", half)
    out, correct = _run("indel_hs.train")
    assert not correct
    assert _failed(out) >= {"loss_gap"}


def test_sound_genome_run_is_correct():
    out, correct = _run("snv_hs.genome", seconds=1.0)
    assert correct, [c for c in out.checks if not c.ok]


def test_altered_answer_is_caught(monkeypatch):
    """Every tenth row's probabilities altered where the farm makes them."""
    from mural_tpu_torch.predict import post_farm
    real = post_farm.native.format_pred_tsv

    def altered(chrom, pos, neg, probs):
        probs = np.array(probs, dtype=np.float64)
        probs[::10, 1] *= 1.01
        return real(chrom, pos, neg, probs)

    monkeypatch.setattr(post_farm.native, "format_pred_tsv", altered)
    out, correct = _run("indel_hs.genome", seconds=1.0)
    assert not correct
    assert _failed(out) == {"prob_gap"}
