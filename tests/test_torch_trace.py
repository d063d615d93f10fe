"""The port's spans and counters (``repro_torch.trace``) inside the MC path.

Under a CPU-only ``torch.profiler`` profile, ``charz.mc_boolean_success``
(one bank, and two fused banks) and ``mc_not_success`` open the documented
span tree, and each counter's per-call value equals the count derived
from the shapes and the code.  Tracing changes no result, and with no
profile nothing is recorded.  ``charz.collect_rows`` hands out the blocks
the MC scores.
"""
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch import trace
from repro_torch.core import charz, isa

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

RB, W = 256, 128            # row bits, shared columns of the small rows
TRIALS = 96
KW = dict(trials=TRIALS, row_bits=RB, module="hynix_4gb_m_2666",
          device="cpu")
CELL = 4                    # bytes of one float32 cell


def _boolean(seed, **kw):
    return charz.mc_boolean_success("nand", 16, seed=seed, **KW, **kw)


def _not(seed, **kw):
    return charz.mc_not_success(1, seed=seed, **KW, **kw)


CALLS = {
    # name: (entry point, keywords, groups, banks per round)
    "boolean.b1": (_boolean, {}, 9, 1),
    "boolean.b2": (_boolean, dict(banks=2, groups=4), 4, 2),
    "not.b1": (_not, {}, 9, 1),
}


def _traced(name, seed):
    """One call under a CPU profile -> (result, pud.* events, records)."""
    fn, kw, _groups, _banks = CALLS[name]
    isa._inventory.cache_clear()        # every bank builds its inventory
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rate = fn(seed, **kw)
    events = [e for e in prof.events() if e.name.startswith("pud.")]
    return rate, events, trace.calls()


def _tree(name) -> dict:
    """Each span's (parent, opens per call), from the documented tree."""
    _fn, _kw, groups, banks = CALLS[name]
    rounds = groups // banks
    root = "pud.mc.not" if name.startswith("not") else "pud.mc.boolean"
    # the BankArray, one bank ISA per bank (pairs), the fused ISA
    chips = 1 + banks + (banks > 1)
    tree = {root: (None, 1), "pud.chip": (root, chips),
            "pud.inventory": ("pud.chip", banks),
            "pud.pairs": (root, banks)}
    per_round = {"pud.operands": root, "pud.apa": root, "pud.score": root,
                 "pud.apa.stage": "pud.apa", "pud.apa.resolve": "pud.apa",
                 "pud.apa.writeback": "pud.apa",
                 "pud.apa.readout": "pud.apa"}
    if root == "pud.mc.boolean":
        per_round["pud.apa.opctx"] = "pud.apa"
    tree.update({k: (p, rounds) for k, p in per_round.items()})
    tree["pud.apa.plan"] = ("pud.apa", 2 * rounds)   # the ISA's, the bank's
    return tree


@pytest.mark.parametrize("name", list(CALLS))
def test_the_span_tree_of_one_call(name):
    _rate, events, recs = _traced(name, seed=7001)
    got = Counter(e.name for e in events)
    parents = {(e.name, e.cpu_parent.name if e.cpu_parent else None)
               for e in events}
    tree = _tree(name)
    assert dict(got) == {k: n for k, (_p, n) in tree.items()}
    assert parents == {(k, p) for k, (p, _n) in tree.items()}
    assert [r["name"] for r in recs] == [next(iter(tree))]


def _counts(name) -> dict:
    """The counters of one call, derived from the shapes and the code."""
    _fn, _kw, groups, banks = CALLS[name]
    rounds = groups // banks
    t = -(-TRIALS // groups) * banks        # trials in one round's episode
    chips = banks + (banks > 1)             # BankSim + PudIsa builds
    if name.startswith("not"):
        # stage the 1 source row; write back 1 destination + 1 source, on
        # the shared columns.  Copies: slot indices of the staging and of
        # both activated sides, the NOT's per-cell success plane
        return {"scatter_bytes": rounds * CELL * t * 3 * W,
                "reads.score": rounds,
                "h2d_copies": 4 * chips + 4 * rounds}
    # 15 constant reference rows and 16 operand rows (shared columns), the
    # Frac row (whole row), then 16 + 16 rows written back
    per_apa = CELL * t * ((15 + 16 + 32) * W + RB)
    # slot indices of the fill, the staging, both activated sides and the
    # op-context sum, and the static offsets; two fused rounds draw their
    # pairs from different cells of the 3x3 region grid, so each misses
    # the analog-parameter cache: its static plane and its thresholds
    per_round = 6 if banks == 1 else 7
    return {"scatter_bytes": rounds * per_apa, "reads.opctx": rounds,
            "reads.score": rounds,
            "h2d_copies": 4 * chips + per_round * rounds}


@pytest.mark.parametrize("name", list(CALLS))
def test_each_counter_equals_its_count_from_the_shapes(name):
    _rate, _events, recs = _traced(name, seed=7002)
    assert len(recs) == 1
    assert recs[0]["counts"] == _counts(name)


@pytest.mark.parametrize("name", ["boolean.b1", "not.b1"])
def test_program_reads_equal_the_host_reads_counted_op_by_op(name):
    """On one bank each read is a scalar read, which ``HostReads`` counts
    on any device (a fused round's ``.cpu()`` of a CPU tensor is no
    copy, so it is left out here)."""
    from bench.syncs import HostReads
    fn, kw, _groups, _banks = CALLS[name]
    trace.clear()
    with HostReads() as reads, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn(7003, **kw)
    counts = trace.calls()[0]["counts"]
    assert counts.get("reads.opctx", 0) + counts["reads.score"] \
        == reads.reads == {"boolean.b1": 18, "not.b1": 9}[name]


@pytest.mark.parametrize("name", list(CALLS))
def test_tracing_changes_no_result_and_keeps_nothing_when_off(name):
    fn, kw, _groups, _banks = CALLS[name]
    trace.clear()
    with charz.collect_rows() as off_rows:
        off = fn(7004, **kw)
    assert trace.calls() == []
    with charz.collect_rows() as on_rows:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            on = fn(7004, **kw)
    assert on == off
    assert len(on_rows) == len(off_rows) == CALLS[name][2] // CALLS[name][3]
    assert all(torch.equal(a, b) for a, b in zip(on_rows, off_rows))


@pytest.mark.parametrize("name", list(CALLS))
def test_collect_rows_hands_out_what_the_hits_wrapper_sees(name):
    from bench.program import result_rows
    fn, kw, _groups, _banks = CALLS[name]
    with result_rows() as wrapped, charz.collect_rows() as hooked:
        rate = fn(7005, **kw)
    assert len(hooked) == len(wrapped) > 0
    assert all(torch.equal(a, b) for a, b in zip(hooked, wrapped))
    assert sum(r.numel() for r in hooked) * rate == pytest.approx(
        round(sum(r.numel() for r in hooked) * rate))


def test_collect_rows_on_the_per_trial_path_and_nested():
    with charz.collect_rows() as outer:
        with charz.collect_rows() as inner:
            charz.mc_not_success(1, seed=3, trials=4, row_bits=RB,
                                 batched=False, device="cpu")
        charz.mc_not_success(1, seed=3, trials=2, row_bits=RB,
                             batched=False, device="cpu")
    assert [tuple(r.shape) for r in inner] == [(W,)] * 4
    assert len(outer) == 6
    assert all(torch.equal(a, b) for a, b in zip(outer, inner))
    assert charz._row_sinks == []


def test_off_a_span_is_the_shared_no_op_and_counters_do_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("pud.a") is trace.span("pud.b")
    assert trace.root("pud.mc.x") is trace.span("pud.c")
    trace.clear()
    trace.count("scatter_bytes", 5)
    x = trace.to_device([1, 2, 3], "cpu", torch.float32)
    assert x.dtype == torch.float32 and x.tolist() == [1.0, 2.0, 3.0]
    with trace.root("pud.mc.x"):
        trace.count("k")
    assert trace.calls() == []


def test_a_root_inside_a_root_counts_into_the_outer_record():
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        trace.count("k")                    # no root open: dropped
        with trace.root("pud.mc.outer"):
            trace.count("k", 2)
            with trace.root("pud.mc.inner"):
                trace.to_device([0], "cpu")
                trace.count("k")
        with trace.root("pud.mc.next"):
            pass
    assert trace.calls() == [
        {"name": "pud.mc.outer", "counts": {"k": 3, "h2d_copies": 1}},
        {"name": "pud.mc.next", "counts": {}}]
    names = {e.name: e.cpu_parent.name if e.cpu_parent else None
             for e in prof.events() if e.name.startswith("pud.")}
    assert names == {"pud.mc.outer": None, "pud.mc.inner": "pud.mc.outer",
                     "pud.mc.next": None}


def test_the_records_are_bounded():
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(trace.MAX_CALLS + 3):
            with trace.root("pud.mc.x"):
                trace.count("i", i)
    recs = trace.calls()
    assert len(recs) == trace.MAX_CALLS
    assert recs[0]["counts"] == {"i": 3}
    trace.clear()
    assert trace.calls() == []
