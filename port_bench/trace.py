"""The traced run: torch.profiler over the window, recording the device's
operations alone (no host operator events, so that the profiler costs the
host little), reduced to device intervals, the device's busy time, its idle
gaps by what the harness was doing, and the device operations that took
most time.

Busy time is the union of the device operations' intervals (kernels,
copies, sets) inside the window, so operations that overlap count once.
The window and the harness's spans (``SpanLog``) are stamped on the
profiler's own clock, the wall clock in nanoseconds.
"""

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

WINDOW_SPAN = "window"
TOP = 10


@dataclass
class Trace:
    window: Tuple[float, float]                  # seconds, on the trace's clock
    ops: List[Tuple[str, float, float]]          # device operations: (name, start, end)
    host: List[Tuple[str, float, float]] = field(default_factory=list)  # harness spans

    @property
    def seconds(self) -> float:
        return self.window[1] - self.window[0]

    def outside(self) -> int:
        """Device operations that do not lie inside the window (none, where
        the profiler's clock is the one the spans were stamped on)."""
        lo, hi = self.window
        return sum(1 for _, s, e in self.ops if s < lo or e > hi)


class SpanLog:
    """The harness's spans, (name, start, end) in seconds on the profiler's
    clock; ``span(name)`` is a context manager for ``traffic``'s windows."""

    clock = staticmethod(time.time_ns)

    def __init__(self):
        self.spans: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = self.clock()
        try:
            yield
        finally:
            self.spans.append((name, t0 * 1e-9, self.clock() * 1e-9))


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def profiler():
    """torch.profiler over the device's operations alone."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def from_profile(prof, spans: SpanLog) -> Trace:
    """The device operations of a finished profile, in seconds, with the
    harness's window and spans."""
    from torch.autograd import DeviceType

    window = [(s, e) for name, s, e in spans.spans if name == WINDOW_SPAN]
    if not window:
        raise RuntimeError("the harness recorded no window span")
    ops = [(e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    host = [s for s in spans.spans if s[0] != WINDOW_SPAN]
    return Trace(window[-1], ops, host)


def busy_seconds(trace: Trace) -> float:
    return union_seconds([(s, e) for _, s, e in trace.ops], *trace.window)


def device_ops(trace: Trace, top: int = TOP):
    """[(name, seconds)] of the operations that took most device time."""
    by_name = defaultdict(float)
    for name, s, e in trace.ops:
        by_name[name] += e - s
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def host_label(trace: Trace, t: float) -> str:
    """The innermost harness span open at t ("none" where none was: the
    host between spans, in the harness's own loop)."""
    open_ = [(s, name) for name, s, e in trace.host if s <= t < e]
    return max(open_)[1] if open_ else "none"


def longest_gaps(trace: Trace, top: int = TOP):
    """[(label, seconds)] of the longest idle stretches of the device in the
    window, each labelled by the harness span open as it began."""
    gaps = idle_gaps([(s, e) for _, s, e in trace.ops], *trace.window)
    gaps.sort(key=lambda g: g[0] - g[1])
    return [(host_label(trace, s), e - s) for s, e in gaps[:top]]
