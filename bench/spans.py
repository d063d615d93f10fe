"""The program's own spans and counters, read for the per-layer metrics.

While a ``torch.profiler`` profile records, the port records host ranges
named ``pud.*`` inside each MC call (one ``pud.mc.*`` root a call) and
keeps one record of counters per call (``repro_torch.trace``).  The spans
arrive with the traced window's host operations (``ctx.trace["host"]``,
:func:`bench.timeline.read`); the records come from
``repro_torch.trace.calls()``, and are taken only where there is one per
traced call.  A program without them gives no ``pud.mc.*`` span and no
records, and every reader here returns None.
"""
from __future__ import annotations

from bench import timeline

#: the prefix of the program's root span, one per MC call
ROOT = "pud.mc."


def _spans(ctx, name: str) -> list[tuple[float, float]] | None:
    """The union of the spans named ``name`` in the traced window, or None
    where the window holds no root span of the program."""
    tr = ctx.trace
    if not tr or not ctx.traced_calls or not any(
            n.startswith(ROOT) for n, _s, _e in tr["host"]):
        return None
    return timeline.merge([(s, e) for n, s, e in tr["host"] if n == name],
                          tr["window"])


def overlap_s(a, b) -> float:
    """Seconds two sorted lists of disjoint (start, end) intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def span_ms(ctx, name: str) -> float | None:
    """Host ms per traced call inside spans named ``name``."""
    spans = _spans(ctx, name)
    if spans is None:
        return None
    return sum(e - s for s, e in spans) / ctx.traced_calls * 1e3


def idle_ms(ctx, name: str) -> float | None:
    """Device-idle ms per traced call while a span named ``name`` is
    open."""
    spans = _spans(ctx, name)
    if spans is None:
        return None
    gaps = timeline.idle_gaps(ctx.trace["device"], ctx.trace["window"])
    return overlap_s(spans, gaps) / ctx.traced_calls * 1e3


def records(ctx) -> list[dict] | None:
    """The program's counter records of the traced calls, one per call, or
    None where the program keeps none or their number differs."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    recs = trace.calls()
    if not ctx.traced_calls or len(recs) != ctx.traced_calls:
        return None
    return recs


def per_call(ctx, *keys: str) -> float | None:
    """The counters ``keys`` summed, per traced call."""
    recs = records(ctx)
    if recs is None:
        return None
    return sum(r["counts"].get(k, 0) for r in recs for k in keys) / len(recs)
