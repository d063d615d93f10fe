"""The serving engine's spans and counters, read for the per-layer metrics
of a served model's cell.

While a ``torch.profiler`` profile records, ``ServeEngine.run`` is one
``serve.run`` root a call, with ``serve.prefill`` (one admitted request)
and ``serve.decode`` (one step) spans, and keeps one record of counters a
call (``repro_torch.trace``): ``serve.prompt_tokens``, ``serve.steps``,
and the grouped expert product's launches, each ``(experts with rows,
rows)`` under ``lists["moe.launch"]``.  The records are the last
``traced_calls`` of the program's ``serve.run`` records (the window's, as
nothing traces after it).  A program without them gives no ``serve.run``
span and no records, and every reader returns None.
"""
from __future__ import annotations

from bench import timeline

#: the engine's root span, one per call
ROOT = "serve.run"


def spans(ctx, name: str) -> list[tuple[float, float]] | None:
    """The spans named ``name`` in the traced window, as (start, end), or
    None where the window holds no root span of the engine."""
    tr = ctx.trace
    if not tr or not ctx.traced_calls or not any(
            n == ROOT for n, _s, _e in tr["host"]):
        return None
    lo, hi = tr["window"]
    return [(max(s, lo), min(e, hi)) for n, s, e in tr["host"]
            if n == name and e > lo and s < hi]


def records(ctx) -> list[dict] | None:
    """The engine's counter records of the traced calls, or None."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    recs = [r for r in trace.calls() if r["name"] == ROOT]
    n = ctx.traced_calls
    if not n or len(recs) < n:
        return None
    return recs[-n:]


def device_s(ctx, prefix: str) -> float:
    """Seconds of the traced window's device operations whose name starts
    with ``prefix``."""
    lo, hi = ctx.trace["window"]
    return sum(e - s for s, e in timeline.merge(
        [(s, e) for n, s, e in ctx.trace["device"] if n.startswith(prefix)],
        (lo, hi)))
