"""The port's device-resident training data (``train/resident.py``)
against the JAX package's and the port's host-fed path on the CPU: the
arena, ``astart``, the resident estimate and the epoch rows equal the
JAX package's exactly (chromosome ends and IUPAC codes included); the
resident windows equal the host batches' bit for bit (codes and one-hot,
both strands); a resident SGD epoch equals the port's host-fed epoch and
JAX's ``make_resident_epoch_fn``, and ``resident_eval`` equals the host
validation and JAX's ``make_resident_eval_fn``; the INDEL resident epoch
equals host-fed; the ``auto`` rule; ``train_trial`` writes the same
metrics with ``resident`` on, auto and off.  Every dropout is 0: Flax
and torch draw different masks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mural_tpu.train.loop as j_loop
from mural_tpu.data.dataset import prepare_dataset as j_prepare
from mural_tpu.genome.fasta import decode_sequence
from mural_tpu.models.registry import build_model as j_build_model
from mural_tpu.train import optim as j_optim
from mural_tpu.train import resident as j_res
from mural_tpu.train.packed import pack_state
from mural_tpu.train.state import create_train_state
from mural_tpu_torch.data.batcher import segment_pool_batches
from mural_tpu_torch.data.dataset import prepare_dataset
from mural_tpu_torch.models.layers import one_hot_from_codes
from mural_tpu_torch.models.registry import build_model
from mural_tpu_torch.train import loop, resident
from mural_tpu_torch.train.graphs import StepGroups, epoch_scalars
from mural_tpu_torch.train.optim import (GraphOptimizer, LRSchedule,
                                         build_optimizer)
from mural_tpu_torch.train.steps import (TrainState, eval_step, model_input,
                                         train_step)
from mural_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_indel_model import one_torch_thread  # noqa: F401
from test_torch_port_train import CONFIG, _rel

KW = dict(central_bp=2000, local_radius=3, local_order=2, distal_radius=60)
B, SEGMENTS = 32, 2
# the port against the JAX package, both float32 (JAX's resident epoch
# packs float32 leaves only): per-step loss tolerance of the port's step
# tests, and per tensor, max |diff| over the tensor's max |value|
TOL_JAX = 1e-4


def write_data(base, rng):
    """A FASTA with IUPAC codes and N, and a sorted SNV BED ('+' on A,
    '-' on T) with sites within a window of both ends of every
    chromosome (the short chrM is shorter than two windows)."""
    fasta, bed = base / "seq.fa", base / "sites.bed"
    rows = []
    with open(fasta, "w") as fh:
        for chrom, n, k in (("chr1", 9000, 120), ("chr2", 4000, 50),
                            ("chrM", 150, 6)):
            codes = rng.integers(0, 4, size=n).astype(np.uint8)
            amb = rng.integers(0, n, size=n // 50)
            codes[amb] = rng.integers(4, 15, size=len(amb))
            fh.write(f">{chrom}\n{decode_sequence(codes)}\n")
            for strand, focal in (("+", 0), ("-", 3)):
                hits = np.flatnonzero(codes == focal)
                ends = np.concatenate([hits[:3], hits[-3:]])
                pos = np.unique(np.concatenate(
                    [ends, rng.choice(hits, size=k, replace=False)]))
                rows += [(chrom, int(p), strand) for p in pos]
    rows.sort(key=lambda r: (r[0], r[1]))
    with open(bed, "w") as fh:
        for i, (chrom, p, strand) in enumerate(rows):
            fh.write(f"{chrom}\t{p}\t{p + 1}\t.\t{i % 4}\t{strand}\n")
    return str(fasta), str(bed)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_resident")
    return (base,) + write_data(base, np.random.default_rng(8))


@pytest.fixture(scope="module")
def dsets(data):
    """(port dataset, JAX dataset) per model type."""
    _, fasta, bed = data
    return {mt: (prepare_dataset(bed, fasta, model_type=mt, **KW),
                 j_prepare(bed, fasta, model_type=mt, **KW))
            for mt in ("snv", "indel")}


@pytest.mark.parametrize("model_type", ["snv", "indel"])
def test_arena_and_estimate_equal_jax(dsets, model_type):
    ds, jds = dsets[model_type]
    arena, astart = resident.build_arena(ds)
    j_arena, j_astart = j_res.build_arena(jds)
    assert arena.dtype == j_arena.dtype == np.uint8
    np.testing.assert_array_equal(arena, j_arena)
    assert astart.dtype == j_astart.dtype
    np.testing.assert_array_equal(astart, j_astart)
    assert set(np.unique(arena)) > set(range(4)) | {14}   # IUPAC and N
    assert (resident.estimate_resident_bytes(ds)
            == j_res.estimate_resident_bytes(jds))
    # windows past both ends of chrM are N-filled, as the host gather
    dw = ds.distal_width
    m = np.flatnonzero(np.asarray(ds.chrom_names)[ds.chrom_id] == "chrM")
    assert len(m) and (arena[astart[m[0]]:astart[m[0]] + dw] == 14).any()


@pytest.mark.parametrize("shuffle,pad_final", [(True, False), (False, True)])
def test_stack_epoch_rows_equal_jax(dsets, shuffle, pad_final):
    ds, jds = dsets["snv"]
    got = resident.stack_epoch_rows(ds, SEGMENTS, B, shuffle,
                                    np.random.default_rng(3), pad_final)
    want = j_res.stack_epoch_rows(jds, SEGMENTS, B, shuffle,
                                  np.random.default_rng(3), pad_final)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


@pytest.mark.parametrize("model_type", ["snv", "indel"])
def test_resident_windows_equal_host_batches(dsets, model_type):
    """Codes (fused stem) and one-hot (unfused) of every valid row, both
    strands, bit for bit against the host batches; labels and k-mer ids
    as int64."""
    ds = dsets[model_type][0]
    res = resident.make_resident(ds, "cpu")
    assert res.arena.dim() == 1 and res.astart.dtype == torch.int64
    n_neg = 0
    for b in segment_pool_batches(ds, SEGMENTS, B, shuffle=False,
                                  pad_final=True):
        rows = torch.from_numpy(np.where(b.rows < 0, 0, b.rows))
        n = b.n_valid
        y, cat, codes, cont = resident.ResidentData.batch(res, rows, True)
        _, _, onehot, _ = res.batch(rows, False)
        assert y.dtype == cat.dtype == torch.int64 and cont is None
        np.testing.assert_array_equal(y[:n].numpy(), b.y[:n])
        np.testing.assert_array_equal(cat[:n].numpy(), b.cat[:n])
        assert codes.dtype == torch.uint8
        np.testing.assert_array_equal(codes[:n].numpy(), b.distal[:n])
        assert torch.equal(
            onehot[:n], one_hot_from_codes(torch.from_numpy(b.distal[:n])))
        n_neg += int(ds.strand_neg[b.rows[:n]].sum())
    assert 0 < n_neg < ds.n_sites


def _models(ds, jds):
    """The JAX SNVNet2 at CONFIG's widths (dropout 0), its init and the
    port's model holding the same weights."""
    n_cat = ds.cat.shape[1]
    common = {"emb_dims": [(17, 2)] * n_cat, "n_cont": 0, "n_class": 4,
              "distal_order": 1, "in_channels": 4}
    jmodel = j_build_model(2, CONFIG, common, "snv")

    class _DS:
        cat = np.zeros((2, n_cat), np.int32)
        n_cont = 0
        distal_width = ds.distal_width
        n_distal_tracks = 0

    variables = j_loop._init_variables(jmodel, _DS(), 4)
    host = jax.tree.map(np.asarray, variables)

    def port_model():
        model = build_model(2, CONFIG, common, "snv")
        model.load_state_dict(state_dict_from_jax(host, model), strict=True)
        return model

    return jmodel, variables, port_model


SCHED = ("StepLR", 1e-4, 0.9, B, 10 ** 4, 1e-4, 1e-6)


def _host_fed_epoch(state, ds, rng, fused, batch_size=B):
    """The host-fed reference: torch's optimizer at float LRs
    (``train_step``) on ``segment_pool_batches``; per-step losses."""
    losses = []
    for b in segment_pool_batches(ds, SEGMENTS, batch_size, shuffle=True,
                                  rng=rng):
        loss, _ = train_step(
            state, torch.from_numpy(b.y).long(),
            torch.from_numpy(b.cat).long(),
            model_input(torch.from_numpy(b.distal), fused),
            torch.ones(batch_size))
        losses.append(float(loss))
    return losses


def _resident_epoch(model, res, rows, fused, optim, wd, k):
    """The resident epoch in groups of k (GraphOptimizer); returns the
    per-step losses and the state."""
    state = TrainState(model, GraphOptimizer(optim, model.parameters(), wd),
                       LRSchedule.build(*SCHED))
    groups = StepGroups(state, k, resident.resident_batch(
        res, fused, torch.ones(rows.shape[1])))
    losses = resident.resident_epoch(groups, rows, torch.from_numpy(
        epoch_scalars(state, len(rows)))).tolist()
    return losses, state


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _close(a, b, rtol, atol):
    for k in b:
        torch.testing.assert_close(a[k], b[k], rtol=rtol, atol=atol,
                                   msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resident_epoch_equals_host_fed_and_jax(dsets, fused):
    """One SGD epoch: resident (GraphOptimizer, one step at a time and in
    groups of 3) against the port's host-fed steps with torch's SGD, with
    the tolerances of tests/test_resident.py (losses rel 1e-5, parameters
    and BN statistics rtol 2e-5 / atol 1e-6; they come out equal); the
    resident epoch against JAX's by its total loss and by the trained
    models' validation logits and loss (``resident_eval`` against
    ``make_resident_eval_fn``, each on its own weights), within TOL_JAX.
    Parameters are not held against JAX one by one: a conv bias that
    feeds a BatchNorm gets only rounding noise for a gradient, and the
    two frameworks' noise differs from the first step."""
    ds, jds = dsets["snv"]
    jmodel, variables, port_model = _models(ds, jds)
    res = resident.make_resident(ds, "cpu")
    rows_np, _, _ = resident.stack_epoch_rows(
        ds, SEGMENTS, B, True, np.random.default_rng(11))
    rows = torch.from_numpy(rows_np.astype(np.int64))

    results = {}
    for k in (1, 3):
        model = port_model()
        state = TrainState(model, build_optimizer("SGD", model.parameters(),
                                                  0.0),
                           LRSchedule.build(*SCHED))
        hl = _host_fed_epoch(state, ds, np.random.default_rng(11), fused)
        hp = _params(model)
        rmodel = port_model()
        rl, rstate = _resident_epoch(rmodel, res, rows, fused, "SGD", 0.0, k)
        rp = _params(rmodel)
        assert rstate.step == state.step == len(rows) == len(rl) > 4
        for a, b in zip(rl, hl):
            assert a == pytest.approx(b, rel=1e-5)
        _close(rp, hp, 2e-5, 1e-6)
        results[k] = (rl, rp, rmodel)

    # the JAX package's resident epoch from the same weights
    jstate = pack_state(create_train_state(
        jmodel, variables, "SGD", 0.0, j_optim.LRSchedule.build(*SCHED)))
    jres = j_res.make_resident(jds)
    epoch_fn = j_res.make_resident_epoch_fn(jmodel, jstate, ds.distal_width,
                                            fused_stem=fused)
    jstate, jtotal, _ = epoch_fn(jstate, jres.arena, jres.y, jres.cat,
                                 jres.cont, jres.astart, jres.neg,
                                 jnp.asarray(rows_np), jax.random.key(0))
    rl, rp, rmodel = results[1]
    assert _rel(sum(rl), float(jtotal)) <= TOL_JAX

    # validation: padded rows and masks, uploaded once
    vrows_np, vmasks_np, n_valids = resident.stack_epoch_rows(
        ds, SEGMENTS, B, False, pad_final=True)
    logits, vloss = resident.resident_eval(
        rmodel, res, torch.from_numpy(vrows_np.astype(np.int64)),
        torch.from_numpy(vmasks_np), fused)
    got = np.concatenate([logits[i, :n].numpy()
                          for i, n in enumerate(n_valids)])
    want, want_loss = [], 0.0
    for b in segment_pool_batches(ds, SEGMENTS, B, shuffle=False,
                                  pad_final=True):
        lg, vl = eval_step(rmodel, torch.from_numpy(b.y).long(),
                           torch.from_numpy(b.cat).long(),
                           model_input(torch.from_numpy(b.distal), fused),
                           torch.from_numpy((np.arange(B) < b.n_valid)
                                            .astype(np.float32)))
        want.append(lg[:b.n_valid].numpy())
        want_loss += float(vl)
    assert float(vloss) == pytest.approx(want_loss, rel=1e-5)
    np.testing.assert_allclose(got, np.concatenate(want), rtol=2e-5,
                               atol=1e-6)
    eval_fn = j_res.make_resident_eval_fn(jmodel, jstate, ds.distal_width,
                                          fused_stem=fused)
    jlg, jvloss = eval_fn(jstate.flat_params, jstate.flat_stats, jres.arena,
                          jres.y, jres.cat, jres.cont, jres.astart, jres.neg,
                          jnp.asarray(vrows_np), jnp.asarray(vmasks_np))
    jlg = np.concatenate([np.asarray(jlg)[i, :n]
                          for i, n in enumerate(n_valids)])
    assert _rel(float(vloss), float(jvloss)) <= TOL_JAX
    assert np.abs(got - jlg).max() <= TOL_JAX * np.abs(jlg).max()


def test_indel_resident_epoch_equals_host_fed(data):
    """The U-Net (the tiny INDEL config, dropout 0): one Adam epoch over
    resident data, one step at a time, equals the host-fed epoch of
    torch's Adam."""
    from test_torch_port_indel_train import CONFIG as INDEL_CONFIG
    _, fasta, bed = data
    ds = prepare_dataset(bed, fasta, model_type="indel",
                         central_bp=INDEL_CONFIG["segment_center"],
                         local_radius=INDEL_CONFIG["local_radius"],
                         local_order=INDEL_CONFIG["local_order"],
                         distal_radius=INDEL_CONFIG["distal_radius"])
    common = {"emb_dims": [(5, 1)] * ds.cat.shape[1], "n_cont": 0,
              "n_class": 4, "distal_order": 1, "in_channels": 4}
    res = resident.make_resident(ds, "cpu")
    rows_np, _, _ = resident.stack_epoch_rows(ds, SEGMENTS, 16, True,
                                              np.random.default_rng(4))
    torch.manual_seed(0)
    init = build_model(0, INDEL_CONFIG, common, "indel").state_dict()
    out = {}
    for path in ("host", "resident"):
        model = build_model(0, INDEL_CONFIG, common, "indel")
        model.load_state_dict(init)
        model.out_fc[1].p = 0.0
        if path == "host":
            state = TrainState(model, build_optimizer(
                "Adam", model.parameters(), 1e-5), LRSchedule.build(*SCHED))
            losses = _host_fed_epoch(state, ds, np.random.default_rng(4),
                                     False, 16)
        else:
            losses, _ = _resident_epoch(
                model, res, torch.from_numpy(rows_np.astype(np.int64)),
                False, "Adam", 1e-5, 1)
        out[path] = (losses, _params(model))
    assert len(out["host"][0]) == len(rows_np) > 4
    for a, b in zip(out["resident"][0], out["host"][0]):
        assert a == pytest.approx(b, rel=1e-5)
    _close(out["resident"][1], out["host"][1], 2e-5, 1e-6)


def _opts(data, tmp_path, **kw):
    _, fasta, bed = data
    return loop.TrainOptions(train_data=bed, ref_genome=fasta, epochs=2,
                             split_seed=0, device="cpu",
                             trial_dir=str(tmp_path), **kw)


@pytest.mark.parametrize("mode,budget,tracks,want", [
    ("auto", None, False, True),      # the 8 GiB default
    ("auto", "fit", False, True),
    ("auto", "short", False, False),  # over the budget
    ("on", "short", False, True),     # 'on' takes no budget
    ("off", None, False, False),
    ("auto", None, True, False),      # distal track channels
    ("on", None, True, False),
    ("auto", "env_short", False, False)])
def test_resident_auto_rule(data, dsets, tmp_path, monkeypatch, mode,
                            budget, tracks, want):
    ds = dsets["snv"][0]
    ds_train = ds.subset_segments(np.arange(ds.n_segments - 1))
    ds_valid = ds.subset_segments(np.arange(ds.n_segments - 1,
                                            ds.n_segments))
    est = (resident.estimate_resident_bytes(ds_train)
           + resident.estimate_resident_bytes(ds_valid))
    kw = {"fit": est, "short": est - 1}
    if budget == "env_short":
        monkeypatch.setenv("MURAL_RESIDENT_MAX_BYTES", str(est - 1))
    if tracks:
        ds_train = dataclasses.replace(ds_train, distal_tracks=object())
    opts = _opts(data, tmp_path, resident=mode,
                 resident_max_bytes=kw.get(budget))
    assert loop.use_resident_data(opts, ds_train, ds_valid, B) is want
    # fewer sites than a batch: host-fed whatever the mode
    assert not loop.use_resident_data(opts, ds_train, ds_valid,
                                      ds_train.n_sites + 1)


def _train(opts, config=CONFIG):
    lines = []
    real = loop.get_printer
    loop.get_printer = lambda *a, **k: (
        lambda *args, **kw: lines.append(" ".join(map(str, args))))
    try:
        metrics = loop.train_trial(config, opts, "snv")
    finally:
        loop.get_printer = real
    return metrics, "\n".join(lines)


def test_resident_auto_valid_budget_fallback(tmp_path):
    """As tests/test_resident.py:464: with a validation file, a budget
    that holds twice the train estimate but not train plus validation
    falls back to host-fed batches, with the JAX package's line."""
    fasta, train_bed = write_data(tmp_path, np.random.default_rng(12))
    valid_bed = str(tmp_path / "valid.bed")
    with open(train_bed) as fh:          # each site 4 times over
        rows = fh.read().splitlines() * 4
    rows.sort(key=lambda r: (r.split("\t")[0], int(r.split("\t")[1])))
    with open(valid_bed, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    kw = dict(model_type="snv", **KW)
    est_t = resident.estimate_resident_bytes(
        prepare_dataset(train_bed, fasta, **kw))
    est_v = resident.estimate_resident_bytes(
        prepare_dataset(valid_bed, fasta, **kw))
    budget = (3 * est_t + est_v) // 2
    assert 2 * est_t <= budget < est_t + est_v
    opts = loop.TrainOptions(train_data=train_bed, ref_genome=fasta,
                             validation_data=valid_bed, epochs=1,
                             device="cpu", trial_dir=str(tmp_path / "t"),
                             resident_max_bytes=int(budget))
    metrics, text = _train(opts, dict(CONFIG, segment_center=2000,
                                      distal_radius=60, local_radius=3,
                                      local_order=2))
    assert np.isfinite(metrics["loss"])
    assert "validation set exceeds the budget" in text
    assert "device-resident data: train arena" not in text
    assert "host-fed batches, 8 eager train steps per group" in text


def test_train_trial_resident_modes_write_same_metrics(data, tmp_path):
    """``resident`` on, auto and off: the same batches and steps, so the
    same metrics files, two epochs with K = 8 (the default)."""
    out = {}
    for mode in ("on", "auto", "off"):
        opts = _opts(data, tmp_path / mode, resident=mode)
        metrics, text = _train(opts)
        assert ("device-resident data: train arena" in text) == (
            mode != "off")
        files = [(tmp_path / mode / f"checkpoint_{e}" /
                  f"epoch_{e}_metrics.txt").read_text() for e in (0, 1)]
        out[mode] = (metrics, files)
    for mode in ("auto", "off"):
        assert out[mode][1] == out["on"][1]
        np.testing.assert_equal(out[mode][0], out["on"][0])   # NaN too
