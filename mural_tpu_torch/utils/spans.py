"""In-memory spans and counters of the port's hot paths.

``span(name, key=None, **attrs)`` times a block (a context manager);
``count(name, value, key=None, **attrs)`` records a counter event.  The
key ties records of one unit of work together: a batch index, a flush
window, a farm chunk's sequence number.  Both record only while the
recorder is on:

- while a ``torch.profiler`` session records (the recorder follows the
  profiler's start and stop in every thread), or
- inside :func:`recording` (``predict_genome --pred_time_view``).

Each off -> on transition starts a new numbered session.  A span is kept
only if the recorder was on, in one session, at its start and at its
end, and the block did not end by an exception: a profiler that starts
or stops inside a span drops that span.  Off, a span costs one attribute
read and hands back a shared no-op context; no clock is read.

While a profiler records the host's operations, a span also enters
``torch.profiler.record_function("mural::<name>")``, so the profiler's
host events show the program's layers on the profiler's own clock (in
its Chrome trace, and between the device's operations).  A profiler of
the device alone keeps no host event, so there a span does not enter
it.  The recorder switches off as the profiler's stop begins, before its
teardown: the session ends where the profiled stretch does.

Records sit in a ring of :data:`RING` entries; a record pushed out of it
counts as a drop of its session.  Each session also keeps per-name
totals (count and summed nanoseconds of a span, count and summed values
of a counter), which cover the whole session whatever the ring dropped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 65536


@dataclasses.dataclass
class Record:
    kind: str                  # 'span' or 'count'
    name: str
    session: int
    thread: str                # the recording thread's name
    start_ns: int              # time.perf_counter_ns(); a counter's time
    end_ns: int
    id: int                    # spans: unique in the process
    parent: Optional[int]      # the enclosing kept-candidate span's id
    key: object = None
    attrs: Dict = dataclasses.field(default_factory=dict)
    value: float = 0.0         # counters


@dataclasses.dataclass
class Session:
    number: int
    dropped: int = 0           # records of it pushed out of the ring
    totals: Dict[str, List] = dataclasses.field(default_factory=dict)


class _Null:
    """The span handed out while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Recorder:
    """The process's spans and counters; see the module's docstring."""

    def __init__(self, ring: int = RING):
        self.on = False            # read without the lock by every span
        self.profiling = False
        self.host = False          # the profiler records host operations
        self._host_next = True     # what the next profiler start records
        self.session = 0           # the current (or last) session's number
        self._forced = 0
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring)
        self._sessions: Dict[int, Session] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    # switches -----------------------------------------------------------

    def _switch(self, profiling: Optional[bool] = None,
                forced: int = 0) -> None:
        with self._lock:
            if profiling is not None:
                self.profiling = profiling
                self.host = profiling and self._host_next
            self._forced += forced
            on = self.profiling or self._forced > 0
            if on and not self.on:
                self.session += 1
                self._sessions[self.session] = Session(self.session)
            self.on = on

    @contextlib.contextmanager
    def recording(self):
        """The recorder on for the block; yields the session's number."""
        self._switch(forced=1)
        try:
            yield self.session
        finally:
            self._switch(forced=-1)

    # records ------------------------------------------------------------

    def span(self, name: str, key=None, **attrs):
        if not self.on:
            return _NULL
        return _Span(self, name, key, attrs)

    def count(self, name: str, value: float, key=None, **attrs) -> None:
        if not self.on:
            return
        stack = self._stack()
        now = time.perf_counter_ns()
        self._keep(Record("count", name, self.session,
                          threading.current_thread().name, now, now, 0,
                          stack[-1].id if stack else None, key, attrs,
                          float(value)), float(value))

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec: Record, amount: float) -> None:
        with self._lock:
            if not self.on or self.session != rec.session:
                return
            ring = self._ring
            if len(ring) == ring.maxlen:
                gone = self._sessions.get(ring[0].session)
                if gone is not None:
                    gone.dropped += 1
            ring.append(rec)
            total = self._sessions[rec.session].totals.setdefault(
                rec.name, [0, 0.0])
            total[0] += 1
            total[1] += amount

    # readers ------------------------------------------------------------

    def sessions(self) -> List[Session]:
        with self._lock:
            return list(self._sessions.values())

    def records(self, session: int) -> List[Record]:
        with self._lock:
            return [r for r in self._ring if r.session == session]

    def totals(self, session: int) -> Dict[str, Tuple[int, float]]:
        """``{name: (count, summed ns or summed value)}`` of a session."""
        with self._lock:
            s = self._sessions.get(session)
            return {} if s is None else {k: (v[0], v[1])
                                         for k, v in s.totals.items()}

    def reset(self) -> None:
        """Forget every record and session (the switches stay)."""
        with self._lock:
            self._ring.clear()
            self._sessions = ({self.session: Session(self.session)}
                              if self.on else {})


class _Span:
    __slots__ = ("rec", "name", "key", "attrs", "session", "id", "parent",
                 "start", "_rf")

    def __init__(self, rec: Recorder, name: str, key, attrs: Dict):
        self.rec, self.name, self.key, self.attrs = rec, name, key, attrs

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(rec._ids)
        self.session = rec.session
        stack.append(self)
        self._rf = None
        if rec.host:
            # looked up at each call, so that a test can stand in for it
            self._rf = torch.profiler.record_function(f"mural::{self.name}")
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        rec = self.rec
        stack = rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is None:
            rec._keep(Record("span", self.name, self.session,
                             threading.current_thread().name, self.start,
                             end, self.id, self.parent, self.key,
                             self.attrs), float(end - self.start))
        return False


RECORDER = Recorder()


def _follow_profiler() -> None:
    """Wrap the functions that ``torch.autograd.profiler`` calls as a
    profiler session starts and ends (every ``torch.profiler.profile``
    goes through them), so that the recorder switches on and off with
    it, in every thread, and numbers each session.  The profiler's own
    thread-local state is not visible to other threads.  The profiler's
    ``_start_trace`` tells whether it records host operations
    (``use_cpu``), and its stop switches the recorder off before the
    teardown.  A torch without these functions leaves the recorder to
    ``recording()`` alone."""
    for name, on in (("_run_on_profiler_start", True),
                     ("_run_on_profiler_stop", False)):
        inner = getattr(_autograd_profiler, name, None)
        if inner is None or getattr(inner, "_mural_spans", False):
            continue

        def hook(inner=inner, on=on):
            inner()
            RECORDER._switch(profiling=on)

        hook._mural_spans = True
        setattr(_autograd_profiler, name, hook)

    cls = getattr(_autograd_profiler, "profile", None)
    start = getattr(cls, "_start_trace", None)
    stop = getattr(cls, "__exit__", None)
    if start is None or stop is None or getattr(start, "_mural_spans",
                                                False):
        return

    def start_trace(self, inner=start):
        RECORDER._host_next = bool(getattr(self, "use_cpu", True))
        try:
            return inner(self)
        finally:
            RECORDER._host_next = True

    def exit_(self, *exc, inner=stop):
        if getattr(self, "enabled", True) and getattr(self, "entered",
                                                      True):
            RECORDER._switch(profiling=False)
        return inner(self, *exc)

    start_trace._mural_spans = exit_._mural_spans = True
    cls._start_trace = start_trace
    cls.__exit__ = exit_


_follow_profiler()
RECORDER._switch(profiling=bool(getattr(_autograd_profiler,
                                         "_is_profiler_enabled", False)))

span = RECORDER.span
count = RECORDER.count
recording = RECORDER.recording
sessions = RECORDER.sessions
records = RECORDER.records
totals = RECORDER.totals
