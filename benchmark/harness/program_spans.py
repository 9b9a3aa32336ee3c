"""The program's own spans and counters (``mural_tpu_torch/utils/
spans.py``), as the per-layer metrics read them.

The recorder is on while a ``torch.profiler`` session records, so each
traced stretch of a run is one of its sessions.  A session is read over
one interval: from the first start to the last end of the spans of the
thread that records the reader's anchor span (the map's main loop, or
the train loop).  Every span is clipped to that interval and a counter
counts only inside it, so work on other threads before the main loop's
first kept span, or after its last (the profiler's own start and stop),
adds nothing.  The readers take the first session whose interval is at
least :data:`MIN_SECONDS` long: the device-only stretch that the device
metrics read (or a retry of its length), not the shorter stretch that
records the host's operations.  Nothing is read from a session that
dropped records, nor from a program without the recorder.  A share is
over the interval.
"""

from __future__ import annotations

from typing import List, Optional

MIN_SECONDS = 1.0


class Session:
    """The records of one recorder session, read over the interval of
    the thread that recorded ``anchor``; ``wall_ns`` is 0 where no span
    is named ``anchor``."""

    def __init__(self, records: List, anchor: str):
        self.records = records
        first = next((r for r in records if r.name == anchor
                      and r.kind == "span"), None)
        own = [r for r in records if first is not None
               and r.kind == "span" and r.thread == first.thread]
        self.t0 = min((r.start_ns for r in own), default=0)
        self.t1 = max((r.end_ns for r in own), default=0)
        self.wall_ns = self.t1 - self.t0

    def named(self, name: str) -> List:
        """The records ``name``: spans that overlap the interval,
        counters inside it."""
        return [r for r in self.records if r.name == name
                and r.start_ns <= self.t1 and r.end_ns >= self.t0]

    def summed_ns(self, name: str) -> int:
        """The summed duration of the spans ``name``, each clipped to the
        interval."""
        return sum(min(r.end_ns, self.t1) - max(r.start_ns, self.t0)
                   for r in self.named(name) if r.kind == "span")

    def share(self, name: str) -> float:
        """The summed duration of the spans ``name``, in % of the
        interval."""
        return 100.0 * self.summed_ns(name) / self.wall_ns


def first_session(anchor: str) -> Optional[Session]:
    try:
        from mural_tpu_torch.utils import spans
    except ImportError:             # a program without the recorder
        return None
    for s in spans.sessions():
        got = Session(spans.records(s.number), anchor)
        if got.wall_ns >= MIN_SECONDS * 1e9:
            return None if s.dropped else got
    return None
