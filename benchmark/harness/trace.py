"""The traced stretch of a window: ``torch.profiler`` over a steady part
of it, reduced to device events, busy time, the top device operations
and the longest idle gaps with what the host was doing in each."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Stretch:
    """Device events (name, start us, duration us) and host events of one
    traced stretch, ``seconds`` long; ``units`` counts the work the
    stretch holds (steps or batches), as the runner counted it."""
    events: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    start_us: float
    seconds: float
    units: int = 0
    # a second stretch traced with the host's operations, whose gaps the
    # breakdown names
    named: Optional["Stretch"] = None

    def kernel_seconds(self, fragment: str) -> Tuple[float, int]:
        """Summed seconds and count of device events whose name holds
        ``fragment``."""
        hits = [d for n, _, d in self.events if fragment in n]
        return sum(hits) / 1e6, len(hits)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals, clipped to the
        stretch."""
        lo_all = self.start_us
        hi_all = self.start_us + self.seconds * 1e6
        spans = sorted((max(s, lo_all), min(s + d, hi_all))
                       for _, s, d in self.events)
        merged: List[List[float]] = []
        for lo, hi in spans:
            if hi <= lo:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged]

    def busy_seconds(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e6

    def device_seconds(self) -> float:
        """Summed duration of every device event (overlaps counted
        twice)."""
        return sum(d for _, _, d in self.events) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        total = {}
        for name, _, d in self.events:
            total[name] = total.get(name, 0.0) + d / 1e6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between busy intervals, each named by the
        innermost host operation running at its middle; taken from the
        stretch traced with the host's operations where there is one."""
        if self.named is not None:
            return self.named.idle_gaps(n)
        busy = self.busy_intervals()
        edges = ([self.start_us] + [x for iv in busy for x in iv]
                 + [self.start_us + self.seconds * 1e6])
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for lo, hi in gaps[:n]:
            mid = (lo + hi) / 2
            inside = [(d, name) for name, s, d in self.host
                      if s <= mid <= s + d]
            name = min(inside)[1] if inside else "no host operation"
            out.append([name, (hi - lo) / 1e6])
        return out


def profiler(host: bool):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA]
                   + ([ProfilerActivity.CPU] if host else []))


def reduce(prof, t_start: float, t_stop: float,
           units: int) -> Optional[Stretch]:
    """A finished profile as a :class:`Stretch`; None when it holds no
    device event (the profiler now and then hands back such a trace)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start),
                float(e.time_range.elapsed_us()))
        (dev if e.device_type == DeviceType.CUDA else host).append(item)
    if not dev:
        return None
    start = min(min(s for _, s, _ in dev), min((s for _, s, _ in host),
                                                default=float("inf")))
    return Stretch(events=dev, host=host, start_us=start,
                   seconds=t_stop - t_start, units=units)


class Tracer:
    """Profiles two stretches of a window on request.  The first records
    the device alone, so that the host runs at its untraced pace: the
    per-layer metrics read it.  The second, shorter, records the host's
    operations too: the breakdown's idle gaps are named from it.  A
    stretch the profiler hands back without device events is made again,
    up to ``attempts`` times in all.  ``begin()``, the work, a
    synchronise, then ``end(units)`` with the work units it held."""

    def __init__(self, attempts: int = 4):
        self.attempts = attempts
        self.tries = 0
        self.stretch: Optional[Stretch] = None
        self.named: Optional[Stretch] = None
        self._prof = None
        self._t0 = 0.0

    @property
    def wanted(self) -> bool:
        return ((self.stretch is None or self.named is None)
                and self.tries < self.attempts)

    @property
    def host(self) -> bool:
        """Whether the next stretch records the host's operations."""
        return self.stretch is not None

    def length(self, seconds: float) -> float:
        """The next stretch's length in a window of ``seconds``."""
        return min(0.5 if self.host else 2.0, 0.2 * seconds)

    def begin(self) -> None:
        self._prof = profiler(self.host)
        self._prof.start()
        self._t0 = time.perf_counter()

    def end(self, units: int) -> None:
        t1 = time.perf_counter()
        self._prof.stop()
        self.tries += 1
        got = reduce(self._prof, self._t0, t1, units)
        self._prof = None
        if self.stretch is None:
            self.stretch = got
        elif got is not None:
            self.named = got
            self.stretch.named = got
