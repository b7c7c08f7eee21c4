"""Idle time by the program's own phase spans: the idle gaps between the
device operations of a profiled slice (``trace.Slice.merged``) whose
middle lies inside a span of one name and inside no span of others.
The spans are ``torch.profiler.record_function`` ranges the program
records itself (``engine.*`` in ``ServeEngine.step``, ``train.*`` in the
train step), on the trace's clock."""

from __future__ import annotations

import bisect


def idle_share(tr, inside: str, outside: tuple[str, ...] = ()) -> float | None:
    """The idle gaps of ``tr`` (a read ``trace.Slice``) whose middle lies
    inside an ``inside`` span and inside no ``outside`` span, summed, in %
    of the slice's wall; None without device records, or where the
    program recorded no ``inside`` span."""
    if tr.wall_s <= 0 or not tr.device:
        return None
    within = _Cover([h for h in tr.host if h[2] == inside])
    if not within:
        return None
    without = _Cover([h for h in tr.host if h[2] in outside])
    merged = tr.merged()
    idle = 0.0
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + start)
        if within.covers(mid) and not without.covers(mid):
            idle += start - end
    return 100.0 * idle * 1e-6 / tr.wall_s


class _Cover:
    """Whether any of a set of (start, end, name) spans covers a time:
    the latest start at or before it, and the farthest end of the spans
    that start by then."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        spans = sorted(spans)
        self.starts = [s for s, _, _ in spans]
        self.reach: list[float] = []
        for _, end, _ in spans:
            self.reach.append(max(end, self.reach[-1]) if self.reach else end)

    def __bool__(self) -> bool:
        return bool(self.starts)

    def covers(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.reach[i] >= t
