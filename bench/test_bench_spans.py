"""The readers of the program's spans and counters (``bench/spans.py``),
worked by hand on synthetic traced windows."""
import pytest

from bench import spans
from bench.conftest import ROOT
from bench.harness import Context
from bench.manifest import load_module

METRICS = ROOT / "bench" / "metrics"


def _reader(name):
    return load_module(METRICS / f"{name}.py", name).read


def _window(calls=2):
    """Two calls in (0, 10) s: an inventory each, APAs whose host work the
    device waits on in part."""
    host = [("pud.mc.boolean", 0.0, 4.5), ("pud.inventory", 0.5, 2.5),
            ("pud.apa", 3.0, 4.0), ("aten::index_put_", 3.1, 3.2),
            ("pud.mc.boolean", 5.0, 10.0), ("pud.inventory", 5.5, 6.5),
            ("pud.inventory", 6.0, 7.0),       # overlaps: counted once
            ("pud.apa", 8.0, 9.5)]
    device = [("k1", 3.5, 3.8), ("k2", 8.0, 9.0), ("k3", 9.2, 11.0)]
    tr = {"window": (0.0, 10.0), "calls": calls, "host": host,
          "device": device}
    return Context(trace=tr, traced_calls=calls)


def test_span_ms_per_call_is_the_union_of_its_spans():
    ctx = _window()
    # (2.0 + 1.5) s of inventory over 2 calls
    assert spans.span_ms(ctx, "pud.inventory") == pytest.approx(1750.0)
    assert _reader("inventory_ms")(ctx) == pytest.approx(1750.0)
    assert spans.span_ms(ctx, "pud.score") == 0.0


def test_the_fused_alias_reads_alike():
    ctx = _window()
    assert _reader("inventory_ms.fused")(ctx) == \
        _reader("inventory_ms")(ctx)


def test_device_idle_time_inside_a_span():
    ctx = _window()
    # pud.apa (3, 4): idle but for k1 (3.5, 3.8) -> 0.7 s; (8, 9.5): k2 runs
    # to 9.0, k3 from 9.2 -> 0.2 s idle
    assert spans.idle_ms(ctx, "pud.apa") == pytest.approx(450.0)
    assert _reader("apa_idle_ms")(ctx) == pytest.approx(450.0)


@pytest.mark.parametrize("a, b, shared", [
    ([(0, 2), (4, 6)], [(1, 5)], 2.0),
    ([(0, 1)], [(1, 2)], 0.0),
    ([], [(0, 9)], 0.0),
    ([(0, 10)], [(1, 2), (3, 4), (9, 12)], 3.0),
])
def test_overlap_of_interval_lists(a, b, shared):
    assert spans.overlap_s(a, b) == pytest.approx(shared)
    assert spans.overlap_s(b, a) == pytest.approx(shared)


def test_a_window_without_the_programs_spans_reads_none():
    ctx = _window()
    ctx.trace["host"] = [h for h in ctx.trace["host"]
                         if not h[0].startswith("pud.mc.")]
    for name in ("inventory_ms", "inventory_ms.fused", "apa_idle_ms"):
        assert _reader(name)(ctx) is None
    assert _reader("inventory_ms")(Context()) is None


def _records(monkeypatch, recs):
    from repro_torch import trace
    monkeypatch.setattr(trace, "calls", lambda: list(recs))


REC = {"name": "pud.mc.boolean",
       "counts": {"scatter_bytes": 1_184_235_520 * 9, "h2d_copies": 58,
                  "reads.opctx": 9, "reads.score": 9}}


def test_counters_per_traced_call(monkeypatch):
    other = {"name": "pud.mc.boolean",
             "counts": {"scatter_bytes": 0, "h2d_copies": 60,
                        "reads.score": 9}}
    _records(monkeypatch, [REC, other])
    ctx = _window()
    assert _reader("scatter_GB_per_call")(ctx) == pytest.approx(
        1_184_235_520 * 9 / 2 / 1e9)
    assert _reader("h2d_copies_per_call")(ctx) == 59.0
    assert _reader("program_reads_per_call")(ctx) == 13.5


@pytest.mark.parametrize("n_records", [0, 1, 3])
def test_records_that_disagree_with_the_traced_calls_read_none(
        monkeypatch, n_records):
    _records(monkeypatch, [REC] * n_records)
    ctx = _window(calls=2)
    for name in ("scatter_GB_per_call", "h2d_copies_per_call",
                 "program_reads_per_call"):
        assert _reader(name)(ctx) is None


def test_a_program_without_its_tracing_module_reads_none(monkeypatch):
    import sys

    import repro_torch
    monkeypatch.delattr(repro_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert spans.records(_window()) is None
    assert _reader("program_reads_per_call")(_window()) is None
