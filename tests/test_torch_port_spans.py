"""The span recorder (``mural_tpu_torch/utils/spans.py``) and its spans in
the genome-wide map and the train step groups, on the CPU: nothing is
recorded and no ``record_function`` is entered outside its two switches
(a ``torch.profiler`` session, ``recording()``); under a profiler the
spans of two threads are kept with their parent, key and thread and
show in the profiler's events as ``mural::<name>`` for as long as the
recorder timed them; a profiler of the device alone keeps the spans but
enters no ``record_function``; the session ends before the profiler's
teardown, and a span cut by its start or stop is dropped; sessions are
numbered and the ring counts what it drops; a map run under a profiler
gives one feed and one issue span a batch and counts the rows it wrote;
the time view prints the recorder's totals; a step group is one
``train.group``."""
import gzip
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from mural_tpu_torch.genome.fasta import Genome, decode_sequence
from mural_tpu_torch.models.init import init_weights
from mural_tpu_torch.models.registry import build_model, \
    build_model_from_config
from mural_tpu_torch.predict import genome_wide as gw
from mural_tpu_torch.train.checkpoint import save_checkpoint
from mural_tpu_torch.train.graphs import StepGroups, epoch_scalars
from mural_tpu_torch.train.optim import GraphOptimizer, LRSchedule
from mural_tpu_torch.train.steps import TrainState, model_input
from mural_tpu_torch.utils import spans
from test_torch_port_indel_model import one_torch_thread  # noqa: F401
from test_torch_port_train import CONFIG

SNV = dict(model_no=2, n_class=4, local_radius=3, local_order=2,
           local_hidden1_size=24, local_hidden2_size=12, emb_dropout=0.1,
           local_dropout=0.1, distal_fc_dropout=0.25, distal_radius=200,
           CNN_kernel_size=3, CNN_out_channels=8, segment_center=5000,
           distal_order=1, n_cont=0, emb_dims=[(17, 2)] * 6)
CHROMS = (("chr2", 3000), ("chr3", 900))
BATCH, CHUNK = 128, 2048


@pytest.fixture
def recorder():
    """The process's recorder, off and emptied."""
    assert not spans.RECORDER.on
    spans.RECORDER.reset()
    yield spans.RECORDER
    spans.RECORDER.reset()


def _profile(all_threads=False):
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=all_threads))


def _last_session():
    return spans.sessions()[-1].number


def _counting_record_function(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    return entered


@pytest.fixture(scope="module")
def triple(tmp_path_factory):
    """A genome and an SNVNet2 checkpoint written by the port."""
    base = tmp_path_factory.mktemp("port_spans")
    rng = np.random.default_rng(3)
    fasta = base / "seq.fa"
    with open(fasta, "w") as fh:
        for chrom, n in CHROMS:
            codes = rng.integers(0, 4, size=n).astype(np.uint8)
            fh.write(f">{chrom}\n{decode_sequence(codes)}\n")
    model = build_model_from_config(SNV, 0, "snv")
    path = str(base / "model" / "model")
    save_checkpoint(path, model, SNV)
    return base, str(fasta), path


def _predict(triple, out, **kw):
    base, fasta, path = triple
    opts = gw.GenomePredictOptions(
        ref_genome=fasta, model_path=path,
        model_config_path=path + ".config.pkl", pred_file=str(base / out),
        focal_base="A", batch_size=BATCH, chunk_size=CHUNK,
        flush_batches=3, device="cpu", **kw)
    lines = []
    total = gw.run_genome_predict(
        opts, "snv", printer=lambda *a: lines.append(" ".join(map(str, a))))
    return total, lines


def _n_batches(fasta):
    return sum(-(-len(pos) // BATCH) for _, pos, _ in gw.iter_focal_sites(
        Genome.from_fasta(fasta), "A", chunk=CHUNK))


def _groups(k):
    """A StepGroups of K = ``k`` on a small SNVNet2, and its batches."""
    n_cat = 7
    common = {"emb_dims": [(17, 2)] * n_cat, "n_cont": 0, "n_class": 4,
              "distal_order": 1, "in_channels": 4}
    model = init_weights(build_model(2, CONFIG, common, "snv"),
                         torch.Generator().manual_seed(5))
    state = TrainState(model, GraphOptimizer("Adam", model.parameters(),
                                             1e-3),
                       LRSchedule("StepLR", 1e-3, 0.9, 2, 1e-4, 1e-6, 5))
    rng = np.random.default_rng(7)
    B = 8
    inputs = (torch.from_numpy(rng.integers(0, 4, size=(5, B))),
              torch.from_numpy(rng.integers(0, 17, size=(5, B, n_cat))),
              torch.from_numpy(rng.integers(0, 4, size=(5, B, 401))
                               .astype(np.uint8)),
              torch.ones(5, B))

    def batch(group, i):
        y, cat, codes, mask = (t[i] for t in group)
        return y, cat, model_input(codes, True), mask, None

    return StepGroups(state, k, batch), inputs


def _run_groups(groups, inputs, k):
    scalars = torch.from_numpy(epoch_scalars(groups.state, 5))
    for g in range(0, 5, k):
        groups.run(scalars[g:g + k], tuple(t[g:g + k] for t in inputs))


def test_off_records_nothing_and_enters_no_record_function(
        recorder, triple, monkeypatch):
    entered = _counting_record_function(monkeypatch)
    assert spans.span("a") is spans.span("b", key=1, steps=2)
    with spans.span("a", key=0):
        spans.count("c", 3.0)
    total, _ = _predict(triple, "off.tsv.gz", n_workers=0)
    assert total > 0
    groups, inputs = _groups(2)
    _run_groups(groups, inputs, 2)
    assert spans.sessions() == [] and not recorder.on
    assert entered == []
    # while on, the stand-in is what a span enters
    with _profile():
        with spans.span("a"):
            pass
    assert entered == ["mural::a"]


def test_profiled_spans_of_two_threads(recorder):
    def worker():
        with spans.span("t.thread", key=2, part="second"):
            time.sleep(0.02)

    with _profile(all_threads=True) as prof:
        with spans.span("t.outer", key=1):
            time.sleep(0.01)
            with spans.span("t.inner", key=1):
                time.sleep(0.02)
                spans.count("t.count", 5, key=1)
            thread = threading.Thread(target=worker, name="second-thread")
            thread.start()
            thread.join(timeout=10)
        assert not thread.is_alive()
    session = _last_session()
    recs = {r.name: r for r in spans.records(session)}
    assert set(recs) == {"t.outer", "t.inner", "t.count", "t.thread"}
    outer, inner = recs["t.outer"], recs["t.inner"]
    assert outer.parent is None and inner.parent == outer.id
    assert recs["t.count"].parent == inner.id
    assert recs["t.count"].value == 5.0 and recs["t.count"].kind == "count"
    assert (outer.key, inner.key, recs["t.thread"].key) == (1, 1, 2)
    assert outer.thread == inner.thread == threading.current_thread().name
    assert recs["t.thread"].thread == "second-thread"
    assert recs["t.thread"].parent is None
    assert recs["t.thread"].attrs == {"part": "second"}
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    events = {e.name: e for e in prof.events() if e.name.startswith("mural")}
    assert set(events) == {"mural::t.outer", "mural::t.inner",
                           "mural::t.thread"}
    for name in ("t.outer", "t.inner", "t.thread"):
        mine = (recs[name].end_ns - recs[name].start_ns) / 1e3
        theirs = events[f"mural::{name}"].time_range.elapsed_us()
        assert abs(mine - theirs) <= max(0.2 * mine, 50.0), name
    totals = spans.totals(session)
    assert totals["t.count"] == (1, 5.0)
    assert totals["t.inner"][0] == 1


def test_span_cut_by_profiler_start_or_stop_is_dropped(recorder):
    prof = _profile()
    with spans.span("before"):
        prof.start()
        with spans.span("inside"):
            pass
        with spans.span("across"):
            prof.stop()
    with spans.recording():
        with spans.span("after_on"):
            pass
        with spans.span("kept_through"):
            prof = _profile()
            prof.start()          # on already: the session goes on
            prof.stop()           # still on (recording)
    first, second = spans.sessions()
    assert [r.name for r in spans.records(first.number)] == ["inside"]
    assert [r.name for r in spans.records(second.number)] == ["after_on",
                                                             "kept_through"]
    # a block left by an exception is not kept
    with spans.recording() as n:
        with pytest.raises(KeyError):
            with spans.span("raised"):
                raise KeyError("x")
    assert spans.records(n) == []


def test_a_profiler_of_the_device_alone_enters_no_record_function(
        recorder, monkeypatch):
    """A profiler that does not record the host's operations
    (``use_cpu`` False, as ``torch.profiler.profile(activities=[CUDA])``
    sets it) keeps the spans but enters no ``record_function``.  Without
    a device to profile alone, a host profile told so stands in."""
    entered = _counting_record_function(monkeypatch)
    prof = _profile()
    prof.prepare_trace()
    prof.profiler.use_cpu = False
    prof.start_trace()
    with spans.span("device_only"):
        pass
    prof.stop()
    with _profile():
        with spans.span("host"):
            pass
    assert entered == ["mural::host"]
    first, second = spans.sessions()[-2:]
    assert [r.name for r in spans.records(first.number)] == ["device_only"]
    assert [r.name for r in spans.records(second.number)] == ["host"]


def test_the_session_ends_before_the_profilers_teardown(recorder,
                                                        monkeypatch):
    import torch.autograd.profiler as autograd_profiler
    inner = autograd_profiler._disable_profiler
    seen = []

    def disable():
        seen.append(spans.RECORDER.on)
        return inner()

    monkeypatch.setattr(autograd_profiler, "_disable_profiler", disable)
    with _profile():
        with spans.span("x"):
            pass
    assert seen == [False] and not spans.RECORDER.on
    assert [r.name for r in spans.records(_last_session())] == ["x"]


def test_sessions_are_numbered_and_the_ring_drops_the_oldest():
    rec = spans.Recorder(ring=4)
    with rec.recording() as first:
        for i in range(3):
            with rec.span("a", key=i):
                pass
    with rec.span("off"):
        pass
    with rec.recording() as second:
        for i in range(3):
            rec.count("b", i)
    assert second == first + 1
    got = {s.number: s for s in rec.sessions()}
    assert sorted(got) == [first, second]
    assert got[first].dropped == 2 and got[second].dropped == 0
    assert [r.key for r in rec.records(first)] == [2]
    assert [r.value for r in rec.records(second)] == [0.0, 1.0, 2.0]
    # the totals cover the whole session, drops included
    assert rec.totals(first)["a"][0] == 3
    assert rec.totals(second)["b"] == (3, 3.0)


def test_profiler_sessions_are_numbered(recorder):
    numbers = []
    for _ in range(3):
        with _profile():
            with spans.span("x"):
                pass
        numbers.append(_last_session())
    assert numbers == [numbers[0], numbers[0] + 1, numbers[0] + 2]
    assert all(len(spans.records(n)) == 1 for n in numbers)


@pytest.mark.parametrize("n_workers", [0, 2])
def test_genome_predict_spans(recorder, triple, n_workers):
    with _profile():
        total, _ = _predict(triple, f"w{n_workers}.tsv.gz",
                            n_workers=n_workers)
    recs = spans.records(_last_session())
    n = _n_batches(triple[1])

    def named(name):
        return [r for r in recs if r.name == name]

    for name in ("genome.feed", "genome.issue"):
        assert [r.key for r in named(name)] == list(range(n)), name
        assert all(r.thread == "MainThread" for r in named(name))
    flushes = named("genome.flush")
    assert [r.key for r in flushes] == list(range(-(-n // 3)))
    waits = named("genome.drain_put_wait")
    assert [r.parent for r in waits] == [r.id for r in flushes]
    assert len(named("genome.card_wait")) == len(flushes)
    submits = named("genome.farm_submit")
    assert {r.thread for r in submits} == {"mural-genome-drain"}
    part = named("farm.inline" if n_workers == 0 else "farm.queue_wait")
    assert part and {r.parent for r in part} <= {r.id for r in submits}
    with gzip.open(triple[0] / f"w{n_workers}.tsv.gz", "rt") as fh:
        rows = sum(1 for _ in fh) - 1
    written = named("farm.rows_written")
    assert sum(r.value for r in written) == rows == total
    assert [r.key for r in written] == list(range(len(written)))
    assert {r.attrs["workers"] for r in written} == {n_workers}
    busy = named("farm.worker_busy_s")
    if n_workers:
        assert len(busy) == len(written)
        assert all(r.value > 0 for r in busy)
        assert {r.thread for r in busy} == {"mural-farm-writer"}
    else:
        assert busy == []
    assert len(named("farm.start")) == len(named("farm.close")) == 1


@pytest.mark.parametrize("n_workers", [0, 2])
def test_time_view_reads_the_recorder(recorder, triple, n_workers):
    total, lines = _predict(triple, f"tv{n_workers}.tsv.gz",
                            n_workers=n_workers, time_view=True)
    assert not recorder.on
    start = lines.index("predict_genome phase timing:")
    rows = [line[2:34].strip() for line in lines[start + 1:-1]]
    farm = (["farm submit: inline postprocess"] if n_workers == 0
            else ["farm submit: queue wait", "farm workers busy (summed)"])
    assert rows == ["load genome", "load checkpoint", "farm start", "feed",
                    "issue", "flush", "flush: drain-queue wait",
                    "card wait (drain thread)", "farm submit (drain thread)",
                    *farm, "farm close", "rows written"]
    totals = spans.totals(_last_session())
    n = _n_batches(triple[1])
    assert totals["genome.feed"][0] == totals["genome.issue"][0] == n
    chunks, rows_written = totals["farm.rows_written"]
    assert rows_written == total
    assert lines[-2].split()[2:] == [f"{total:,}", "in", str(chunks),
                                     "chunks"]
    assert lines[-1].startswith(f"genome-wide predict: {total:,} sites")


@pytest.mark.parametrize("k", [1, 2])
def test_step_groups_spans(recorder, k):
    groups, inputs = _groups(k)
    with _profile():
        _run_groups(groups, inputs, k)
    recs = [r for r in spans.records(_last_session())
            if r.name.startswith("train.")]
    assert [r.name for r in recs] == ["train.group"] * (-(-5 // k))
    assert sum(r.attrs["steps"] for r in recs) == 5 == groups.state.step
    assert {r.attrs["mode"] for r in recs} == {"eager"}
    assert [r.key for r in recs] == list(range(0, 5, k))


def test_host_fed_epoch_spans(recorder, tmp_path, monkeypatch):
    """A host-fed ``train_trial`` of two epochs: one ``train.group`` a
    step (K = 1), on the training thread, and no other ``train.`` span."""
    from mural_tpu_torch.train import loop
    from test_torch_port_tracks import write_genome
    fasta, bed = write_genome(tmp_path, np.random.default_rng(6),
                              {"chr1": 20_000}, 120)
    opts = loop.TrainOptions(train_data=bed, ref_genome=fasta, epochs=2,
                             split_seed=0, device="cpu", resident="off",
                             steps_per_dispatch=1,
                             trial_dir=str(tmp_path / "trial"))
    monkeypatch.setattr(loop, "get_printer",
                        lambda *a, **k: lambda *args, **kw: None)
    with spans.recording() as session:
        loop.train_trial(CONFIG, opts, "snv")
    recs = [r for r in spans.records(session)
            if r.name.startswith("train.")]
    steps = len(recs) // 2
    assert steps > 0 and len(recs) == 2 * steps
    assert {r.name for r in recs} == {"train.group"}
    assert [r.key for r in recs] == list(range(2 * steps))
    assert {(r.attrs["steps"], r.attrs["mode"]) for r in recs} == {
        (1, "eager")}
    assert {r.thread for r in recs} == {threading.current_thread().name}
