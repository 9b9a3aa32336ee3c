"""The per-layer metrics that read the program's spans and counters
(``harness/program_spans.py``), on synthetic recorder sessions: each
gives its share over the main loop's interval, every span clipped to it
and only the counters inside it counted; none reads a run without a
session whose main loop spans a second, a session that dropped records,
or a program without the recorder; and
``spec.load_cell`` lists each for exactly its cells."""

import sys
from pathlib import Path

import pytest

from harness import program_spans, spec
from harness.outcome import Outcome

MAP_METRICS = ("feed_pct.predict", "issue_pct.predict",
               "card_wait_pct.predict", "farm_wait_pct.predict",
               "farm_busy_pct.predict")
TRAIN_METRICS = ("step_issue_ms.train",)
MS = 1_000_000


class Rec:
    def __init__(self, name, start_ms, end_ms, kind="span", value=0.0,
                 thread="MainThread", **attrs):
        self.name, self.kind, self.value, self.attrs = name, kind, value, \
            attrs
        self.thread = thread
        self.start_ns, self.end_ns = int(start_ms * MS), int(end_ms * MS)


class Sess:
    def __init__(self, number, dropped=0):
        self.number, self.dropped = number, dropped


def _fake(monkeypatch, sessions, records):
    from mural_tpu_torch.utils import spans
    monkeypatch.setattr(spans, "sessions", lambda: sessions)
    monkeypatch.setattr(spans, "records", lambda n: records.get(n, []))


def _read(name, kind):
    return spec.load_module("metrics", name).read(
        Outcome(0, 0, {}, 0, 0, [], 0, facts={"kind": kind}), None)


# a map session whose main loop runs from 0 to 2000 ms; the drain and
# writer threads' records before 0 or after 2000 ms are clipped away
DRAIN, WRITER = "mural-genome-drain", "mural-farm-writer"
MAP = [Rec("genome.card_wait", -400, -100, thread=DRAIN),
       Rec("farm.worker_busy_s", -50, -50, "count", 9.0, WRITER,
           workers=6),
       Rec("genome.feed", 0, 500), Rec("genome.issue", 500, 1000),
       Rec("genome.feed", 1000, 1100), Rec("genome.issue", 1100, 1500),
       Rec("genome.flush", 1500, 2000),
       Rec("genome.card_wait", -10, 1590, thread=DRAIN),
       Rec("farm.queue_wait", 1700, 2600, thread=DRAIN),
       Rec("farm.worker_busy_s", 900, 900, "count", 3.0, WRITER,
           workers=6),
       Rec("farm.worker_busy_s", 1900, 1900, "count", 3.0, WRITER,
           workers=6),
       Rec("farm.worker_busy_s", 2100, 2100, "count", 9.0, WRITER,
           workers=6),
       Rec("genome.card_wait", 2200, 3000, thread=DRAIN)]
EXPECT = {"feed_pct.predict": 30.0, "issue_pct.predict": 45.0,
          "card_wait_pct.predict": 79.5, "farm_wait_pct.predict": 15.0,
          "farm_busy_pct.predict": 50.0}


def test_map_metrics_read_the_first_long_session(monkeypatch):
    # an empty session, a sub-second one, then the stretch, then another
    _fake(monkeypatch, [Sess(1), Sess(2), Sess(3), Sess(4)],
          {2: [Rec("genome.feed", 0, 300)], 3: MAP,
           4: [Rec("genome.feed", 0, 1500)]})
    for name, want in EXPECT.items():
        assert _read(name, "predict") == pytest.approx(want), name
        assert _read(name, "train") is None


def test_farm_busy_inline(monkeypatch):
    _fake(monkeypatch, [Sess(1)],
          {1: [Rec("genome.feed", 0, 1000), Rec("farm.inline", 200, 450,
                                                thread=DRAIN),
               Rec("farm.inline", 900, 1200, thread=DRAIN)]})
    assert _read("farm_busy_pct.predict", "predict") == pytest.approx(35.0)
    assert _read("farm_wait_pct.predict", "predict") == 0.0


def test_step_issue_ms(monkeypatch):
    _fake(monkeypatch, [Sess(4)],
          {4: [Rec("train.group", 0, 4, steps=8, mode="replay"),
               Rec("train.group", 1500, 1504, steps=8, mode="replay"),
               Rec("genome.feed", 200, 300)]})
    assert _read("step_issue_ms.train", "train") == pytest.approx(0.5)
    assert _read("step_issue_ms.train", "predict") is None


@pytest.mark.parametrize("sessions, records", [
    ([], {}),                                        # no session
    ([Sess(1)], {1: [Rec("genome.feed", 0, 300),     # only a short one
                     Rec("genome.issue", 300, 900)]}),
    ([Sess(1)], {1: [Rec("genome.feed", 0, 300),     # long on another
                     Rec("genome.card_wait", 0, 5000, thread=DRAIN),
                     Rec("train.group", 0, 900, thread="other")]}),
    ([Sess(1, dropped=3)], {1: MAP}),                # records dropped
    ([Sess(1, dropped=3), Sess(2)], {1: MAP, 2: MAP}),
])
def test_nothing_to_read(monkeypatch, sessions, records):
    _fake(monkeypatch, sessions, records)
    for name in MAP_METRICS:
        assert _read(name, "predict") is None, name
    assert _read("step_issue_ms.train", "train") is None


def test_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "mural_tpu_torch.utils.spans", None)
    assert program_spans.first_session("genome.feed") is None
    for name in MAP_METRICS:
        assert _read(name, "predict") is None


def test_cells_list_the_span_metrics():
    root = Path(spec.HERE).parent
    for cell in ("snv_hs.genome", "indel_hs.genome", "snv_hs.train",
                 "indel_hs.train"):
        names = {m["name"] for m in spec.load_cell(root, cell).per_layer}
        want = MAP_METRICS if cell.endswith(".genome") else TRAIN_METRICS
        other = TRAIN_METRICS if cell.endswith(".genome") else MAP_METRICS
        assert set(want) <= names, cell
        assert not set(other) & names, cell
