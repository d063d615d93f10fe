"""The traced window: device intervals, the idle share and the breakdown.

:func:`read` turns a finished ``torch.profiler.profile`` into plain lists:
the device operations (kernels, copies, sets) and the host operations, each
``(name, start_s, end_s)`` on the profiler's clock, and the window, from
the first benchmark span's start to the last one's end.  The arithmetic
below takes only those lists, so it is tested without a card.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

#: the benchmark's own span around each timed call
CALL_SPAN = "bench.call"
#: a host operation at an idle gap's start that no torch operation covers
NO_OP = "python, outside any torch operation"


def read(prof) -> dict:
    """Device ops, host ops and the window of a finished profile."""
    from torch.autograd import DeviceType
    dev, host, calls = [], [], []
    for e in prof.events():
        item = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            if e.name != CALL_SPAN:      # the span's device-side annotation
                dev.append(item)
        elif e.name == CALL_SPAN:
            calls.append(item)
        else:
            host.append(item)
    window = (min(c[1] for c in calls), max(c[2] for c in calls)) \
        if calls else (0.0, 0.0)
    return {"device": dev, "host": host, "window": window,
            "calls": len(calls)}


def merge(intervals, window) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to the window, sorted."""
    lo, hi = window
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_s(device, window) -> float:
    """Seconds of the window in which some device operation ran."""
    return sum(e - s for s, e in merge([(d[1], d[2]) for d in device],
                                       window))


def idle_gaps(device, window) -> list[tuple[float, float]]:
    """The stretches of the window with no device operation running."""
    gaps, t = [], window[0]
    for s, e in merge([(d[1], d[2]) for d in device], window):
        if s > t:
            gaps.append((t, s))
        t = e
    if window[1] > t:
        gaps.append((t, window[1]))
    return gaps


def _innermost(host_sorted, starts, t: float) -> str:
    """Name of the latest-starting host operation running at time t."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(host_sorted[max(0, i - 256):i]):
        if s <= t < e:
            return name
    return NO_OP


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the host operation running at each gap's midpoint (at its start the
    host is as a rule still returning from the wait that the gap ends):
    each a list of at most ``top`` ``[name, seconds]``."""
    ops = defaultdict(float)
    for name, s, e in tr["device"]:
        ops[name[:120]] += e - s
    host = sorted(tr["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = defaultdict(float)
    for s, e in idle_gaps(tr["device"], tr["window"]):
        gaps[_innermost(host, starts, 0.5 * (s + e))[:120]] += e - s

    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": largest(ops), "idle_gaps": largest(gaps)}
