"""K train steps per group (``mural_tpu_torch/train/graphs.py``) on the
CPU, where a group runs the code that a CUDA graph captures on the card,
eagerly: the LR and Adam's bias corrections read from a device tensor
(``epoch_scalars``) by ``GraphOptimizer``.  Held against K single steps
of torch's optimizers at float LRs (``train_step``): Adam, AdamW2 and
SGD under StepLR (a decay and a restart inside a group), StepLR2 (a
restart inside a group, and at the epoch) and ROP (a new LR at the
epoch), two epochs of two groups and two leftover single steps each;
``TrainState.step``; the default K; the replay count of the K2/K3
launches a capture records; ``--profile_dir`` writing a trace that
holds the program's spans."""
import json
import os

import numpy as np
import pytest
import torch

from mural_tpu_torch.models.init import init_weights
from mural_tpu_torch.models.registry import build_model
from mural_tpu_torch.ops import fused_train_stem as fts
from mural_tpu_torch.ops._build import (add_launches, captured_launches,
                                        count_launches)
from mural_tpu_torch.train import loop
from mural_tpu_torch.train.graphs import (StepGroups, epoch_scalars,
                                          steps_per_dispatch)
from mural_tpu_torch.train.optim import (GraphOptimizer, LRSchedule,
                                         build_optimizer)
from mural_tpu_torch.train.steps import TrainState, model_input, train_step
from test_torch_port_indel_model import one_torch_thread  # noqa: F401
from test_torch_port_train import CONFIG

# per-step loss and per-parameter tensor (max |diff| over the tensor's
# max |value|), groups against single steps; every run below reaches 0:
# GraphOptimizer keeps the order of torch's single-tensor CPU updates
TOL = 1e-6
K, STEPS, EPOCHS, B = 4, 10, 2, 16
SCHEDULES = {
    # decays at steps 2, 4 and 6; 1e-2 * 0.5**3 < min_lr: restart at 6
    "StepLR": LRSchedule("StepLR", 1e-2, 0.5, 2, 2e-3, 1.5e-3, STEPS),
    # 1e-3 * 0.85**5 < min_lr: restart at step 5; epoch 1 restarts too
    "StepLR2": LRSchedule("StepLR2", 1e-3, 0.85, 1, 1e-3, 5e-4, STEPS),
    "ROP": LRSchedule("ROP", 1e-3, 0.2, 1, 1e-4, 1e-6, STEPS),
}


def _batches(seed, n_cat):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(EPOCHS * STEPS):
        codes = rng.integers(0, 4, size=(B, 401)).astype(np.uint8)
        codes[rng.random((B, 401)) < 0.01] = 14
        out.append((torch.from_numpy(rng.integers(0, 4, size=B)),
                    torch.from_numpy(rng.integers(0, 17, size=(B, n_cat))),
                    torch.from_numpy(codes), torch.ones(B)))
    return out


def _run(optim, sched, grouped):
    """Two epochs; returns (per-step losses, parameters, state.step)."""
    n_cat = 7
    common = {"emb_dims": [(17, 2)] * n_cat, "n_cont": 0, "n_class": 4,
              "distal_order": 1, "in_channels": 4}
    model = init_weights(build_model(2, CONFIG, common, "snv"),
                         torch.Generator().manual_seed(5))
    state = TrainState(model, (GraphOptimizer if grouped else
                               build_optimizer)(optim, model.parameters(),
                                                1e-2), SCHEDULES[sched])
    batches = _batches(7, n_cat)

    def batch(inputs, i):
        y, cat, codes, mask = (t[i] for t in inputs)
        return y, cat, model_input(codes, True), mask, None

    groups = StepGroups(state, K, batch) if grouped else None
    losses = []
    for epoch in range(EPOCHS):
        epoch_b = batches[epoch * STEPS:(epoch + 1) * STEPS]
        if grouped:
            scalars = torch.from_numpy(epoch_scalars(state, STEPS))
            for g in range(0, STEPS, K):
                inputs = tuple(torch.stack(t) for t in
                               zip(*epoch_b[g:g + K]))
                losses += groups.run(scalars[g:g + K], inputs).tolist()
        else:
            for y, cat, codes, mask in epoch_b:
                loss, lr = train_step(state, y, cat, model_input(codes, True),
                                      mask)
                losses.append(float(loss))
        state.epoch += 1
        state.rop_lr = 2e-4          # ROP's reduction after epoch 0
    return losses, [p.detach().clone() for p in model.parameters()], \
        state.step


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("optim", ["Adam", "AdamW2", "SGD"])
def test_groups_match_single_steps(optim, sched):
    got, got_p, got_step = _run(optim, sched, True)
    want, want_p, want_step = _run(optim, sched, False)
    assert got_step == want_step == EPOCHS * STEPS
    assert len(got) == len(want) == EPOCHS * STEPS
    for a, b in zip(got, want):
        assert abs(a - b) <= TOL * abs(b)
    for a, b in zip(got_p, want_p):
        assert (a - b).abs().max() <= TOL * b.abs().max()


def test_epoch_scalars_follow_the_schedule():
    """Row i: the schedule's LR of step state.step + i, Adam's bias
    corrections of its 1-based count, AdamW's decay."""
    model = torch.nn.Linear(2, 2)
    for name in ("Adam", "AdamW2", "SGD"):
        state = TrainState(model, GraphOptimizer(name, model.parameters(),
                                                 1e-2), SCHEDULES["StepLR"])
        state.step, state.epoch = 3, 1
        rows = epoch_scalars(state, 6)
        assert rows.dtype == np.float32 and rows.shape == (6, 4)
        for i, row in enumerate(rows):
            lr = SCHEDULES["StepLR"].lr_at(3 + i, 1)
            t = 4 + i
            want = ((lr, 0, 0, 0) if name == "SGD" else
                    (lr, lr / (1 - 0.9 ** t), (1 - 0.999 ** t) ** 0.5,
                     1 - lr * 1e-2))
            np.testing.assert_allclose(row, want, rtol=1e-7)


def test_default_steps_per_dispatch():
    """8 for SNV and 1 for INDEL by default, the flag's value otherwise,
    1 while profiling (``mural_tpu/train/loop.py:431-436``)."""
    assert steps_per_dispatch(None, "snv") == 8
    assert steps_per_dispatch(None, "indel") == 1
    assert steps_per_dispatch(4, "indel") == 4
    assert steps_per_dispatch(0, "snv") == 1
    assert steps_per_dispatch(None, "snv", "prof") == 1
    assert steps_per_dispatch(16, "snv", "prof") == 1


def test_captured_launches_count_at_each_replay():
    """Launches on a stream that a graph is capturing go to the capture's
    tally, not the counters; each replay adds the tally."""
    class Stream:
        cuda_stream = 12345

    fwd0, bwd0 = fts.FWD_LAUNCHES, fts.BWD_LAUNCHES
    with captured_launches(Stream()) as tally:
        count_launches(fts, "FWD_LAUNCHES", 1, 12345)
        count_launches(fts, "BWD_LAUNCHES", 1, 12345)
        count_launches(fts, "FWD_LAUNCHES", 1, 12345)
        # another stream: counted now
        count_launches(fts, "FWD_LAUNCHES", 1, 999)
    assert tally == {(fts, "FWD_LAUNCHES"): 2, (fts, "BWD_LAUNCHES"): 1}
    assert (fts.FWD_LAUNCHES, fts.BWD_LAUNCHES) == (fwd0 + 1, bwd0)
    for _ in range(3):
        add_launches(tally)
    # no capture any more
    count_launches(fts, "FWD_LAUNCHES", 1, 12345)
    count_launches(fts, "BWD_LAUNCHES", 1, 12345)
    assert (fts.FWD_LAUNCHES, fts.BWD_LAUNCHES) == (fwd0 + 8, bwd0 + 4)


def test_profile_dir_writes_a_trace(tmp_path):
    """``--profile_dir``: torch.profiler over epoch 0's train steps, one
    eager step per batch, a Chrome trace in the directory."""
    from test_torch_port_tracks import write_genome
    fasta, bed = write_genome(tmp_path, np.random.default_rng(6),
                              {"chr1": 20_000}, 120)
    lines = []
    prof = tmp_path / "prof"
    opts = loop.TrainOptions(train_data=bed, ref_genome=fasta, epochs=1,
                             split_seed=0, device="cpu",
                             trial_dir=str(tmp_path / "trial"),
                             profile_dir=str(prof))
    real = loop.get_printer
    loop.get_printer = lambda *a, **k: (
        lambda *args, **kw: lines.append(" ".join(map(str, args))))
    try:
        loop.train_trial(CONFIG, opts, "snv")
    finally:
        loop.get_printer = real
    text = "\n".join(lines)
    assert f"profiler trace written to {prof}" in text
    assert "one eager train step per batch" in text
    files = os.listdir(prof)
    assert files == ["train_epoch0.pt.trace.json"]
    events = json.loads((prof / files[0]).read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    # the program's spans, on the profiler's clock
    assert any(e.get("name") == "mural::train.group" for e in events)
