"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the same inputs (CPU).

Mirrors ``tests/test_analysis.py``, ``tests/test_schedule.py`` and the
verify half of ``tests/test_engine_config.py``:

* plan verifier: the zoo plans and seeded random DAG plans verify clean in
  both packages; every seeded corruption (program-level SSA defects and
  plan mutations) gives the same ``(rule, severity, site)`` findings;
* the ``verify`` wiring: ``schedule_resident`` / ``ResidentSession`` raise
  ``PlanVerificationError`` on ERROR findings, ``default_verify`` and
  ``EngineConfig.resolved_verify`` follow ``FCDRAM_VERIFY`` the same way;
* timing lint: ``TimingReport`` / ``ArrayTimingReport`` fields equal on the
  same command logs (synthetic streams, sim logs of the same program, a
  4-bank array), and the rank-level scans / bounds equal;
* scheduler: ``ScheduledTimeline`` makespans, stalls, refreshes and issue
  times equal, ``relint() == 0``; ``BankArray.legal_makespan_ns``,
  ``PudEngine.schedule_timing`` and the MC ``stats=`` dict equal the
  reference's under ``draws="numpy"``.

Plans of both packages come from empty scheduler caches, so both run the
same search.  Tolerance: exact everywhere (pure Python over equal plans
and logs).
"""
import dataclasses

import numpy as np
import pytest

from repro import analysis as RA
from repro.analysis.timing import Primitive as RPrim
from repro.core import charz as RC
from repro.core import compiler as RCC
from repro.core.bankarray import BankArray as RArray
from repro.core.device import get_module, timings_for
from repro.core.isa import PudIsa as RIsa
from repro.core.policy import EngineConfig as RConfig
from repro.core.policy import ResidentPolicy as RP
from repro.core.simulator import BankSim as RSim
from repro.core.simulator import CommandLog as RLog
from repro.pud.engine import PudEngine as REngine
from repro_torch import analysis as TA
from repro_torch.analysis.timing import Primitive as TPrim
from repro_torch.core import charz as TC
from repro_torch.core import compiler as TCC
from repro_torch.core.bankarray import BankArray as TArray
from repro_torch.core.device import timings_for as t_timings_for
from repro_torch.core.isa import PudIsa as TIsa
from repro_torch.core.policy import EngineConfig as TConfig
from repro_torch.core.policy import ResidentPolicy as TP
from repro_torch.core.simulator import BankSim as TSim
from repro_torch.core.simulator import CommandLog as TLog
from repro_torch.pud.engine import PudEngine as TEngine

NP = dict(draws="numpy", device="cpu")
POLICIES = ("greedy", "scheduled")
CMDS = ("WR", "RD", "RC", "FRAC", "APA")


@pytest.fixture(autouse=True)
def _fresh_schedule_caches():
    RCC._SCHED_CACHE.clear()
    TCC._SCHED_CACHE.clear()
    yield


def _isas(trials=None, row_bits=128, seed=9):
    kw = dict(row_bits=row_bits, error_model="ideal", seed=seed,
              trials=trials)
    return RIsa(RSim(**kw)), TIsa(TSim(**kw, device="cpu"))


def _plans(prog_r, prog_t, policy, **kw):
    ri, ti = _isas(**kw)
    return (RCC.schedule_resident(prog_r, ri, policy=policy, verify=False),
            TCC.schedule_resident(prog_t, ti, policy=policy, verify=False))


def _key(findings):
    return [(f.rule, f.severity, f.site) for f in findings]


def _T():
    return timings_for(get_module()), t_timings_for(get_module())


# ---------------------------------------------------------------------------
# plan verifier: clean plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", RC.PROGRAMS + RC.WORKLOAD_PROGRAMS)
def test_zoo_plans_verify_clean_in_both(name, policy):
    prog_r, prog_t = RC.get_program(name), TC.get_program(name)
    rplan, tplan = _plans(prog_r, prog_t, policy)
    assert TA.verify_program(prog_t) == []
    assert TA.verify_plan(prog_t, tplan) == []
    assert RA.verify_plan(prog_r, rplan) == []


def _random_dag(cc, rng):
    """A random SSA program in package ``cc``: 1-4 inputs, an optional
    const, 1-10 Boolean / NOT ops over earlier registers, 1-2 outputs."""
    prog = cc.Program()
    n_in = int(rng.integers(1, 5))
    for k in range(n_in):
        prog.instrs.append(cc.Instr("input", k, name=f"x{k}"))
    regs = list(range(n_in))
    if rng.integers(2):
        prog.instrs.append(cc.Instr("const", len(regs),
                                    value=bool(rng.integers(2))))
        regs.append(len(regs))
    for _ in range(int(rng.integers(1, 11))):
        op = ("not", "and", "or", "nand", "nor")[int(rng.integers(5))]
        n = 1 if op == "not" else int(rng.integers(2, 4))
        srcs = tuple(int(regs[i]) for i in rng.integers(0, len(regs), n))
        prog.instrs.append(cc.Instr(op, len(regs), srcs))
        regs.append(len(regs))
    prog.n_regs = len(regs)
    prog.outputs["out"] = regs[-1]
    if rng.integers(2):
        prog.outputs["aux"] = int(regs[int(rng.integers(len(regs)))])
    return prog


@pytest.mark.parametrize("case", range(8))
def test_random_dag_plans_verify_clean(case):
    """The seeded twin of the reference's hypothesis property: a random
    program's plans (both policies) verify clean in both packages."""
    prog_r = _random_dag(RCC, np.random.default_rng(case))
    prog_t = _random_dag(TCC, np.random.default_rng(case))
    for policy in POLICIES:
        rplan, tplan = _plans(prog_r, prog_t, policy, row_bits=64,
                              seed=case)
        assert TA.verify_plan(prog_t, tplan) == []
        assert RA.verify_plan(prog_r, rplan) == []


def test_session_replans_verify_with_carried_state():
    prog = TC.get_program("xor")
    _ri, ti = _isas(trials=2)
    sess = TCC.ResidentSession(prog, ti, policy="scheduled", verify=True)
    rng = np.random.default_rng(0)
    for _ in range(3):          # block 2+ replans against carried rows
        sess.run({n: rng.integers(0, 2, (2, ti.width), dtype=np.uint8)
                  for n in ("a", "b")})
    assert len(sess.plans) == 3


# ---------------------------------------------------------------------------
# plan verifier: seeded corruptions give the reference's findings
# ---------------------------------------------------------------------------
def _prog(cc, case):
    I = cc.Instr
    return {
        "ssa_multi": cc.Program([I("input", 0, name="a"),
                                 I("input", 0, name="b")], {"out": 0}, 1),
        "ssa_undef": cc.Program([I("and", 0, (1, 2))], {"out": 0}, 3),
        "arity_one": cc.Program([I("input", 0, name="a"),
                                 I("and", 1, (0,))], {"out": 1}, 2),
        "arity_17": cc.Program([I("input", 0, name="a"),
                                I("nor", 1, (0,) * 17)], {"out": 1}, 2),
        "arity_not2": cc.Program([I("input", 0, name="a"),
                                  I("not", 1, (0, 0))], {"out": 1}, 2),
        "arity_leaf": cc.Program([I("input", 0, name="a"),
                                  I("input", 1, (0,), name="b")],
                                 {"out": 1}, 2),
        "op_unknown": cc.Program([I("xor3", 0)], {"out": 0}, 1),
        "out_undef": cc.Program([I("input", 0, name="a")], {"out": 42}, 1),
    }[case]


@pytest.mark.parametrize("case", ["ssa_multi", "ssa_undef", "arity_one",
                                  "arity_17", "arity_not2", "arity_leaf",
                                  "op_unknown", "out_undef"])
def test_program_findings_equal_reference(case):
    got = _key(TA.verify_program(_prog(TCC, case)))
    assert got and got == _key(RA.verify_program(_prog(RCC, case)))
    # a malformed program short-circuits the plan replay
    rplan, tplan = _plans(RC.get_program("xor"), TC.get_program("xor"),
                          "greedy")
    assert _key(TA.verify_plan(_prog(TCC, case), tplan)) == \
        _key(RA.verify_plan(_prog(RCC, case), rplan))


def _mutate(prog, plan, case):
    """Apply one seeded corruption (tests/test_analysis.py's matrix)."""
    def set_step(si, **changes):
        plan.steps[si] = dataclasses.replace(plan.steps[si], **changes)
    bools = [i for i, s in enumerate(plan.steps) if s.kind == "bool"]
    if case == "polarity":
        set_step(bools[0], demorgan=not plan.steps[bools[0]].demorgan)
    elif case == "row_alias":
        ins = [i.dst for i in prog.instrs if i.op == "input"]
        si, k, src = next((si, k, s) for si in bools
                          for k, s in enumerate(plan.steps[si].sources)
                          if s[0] == "write"
                          and any(r != s[1] for r in ins))
        srcs = list(plan.steps[si].sources)
        srcs[k] = ("write", next(r for r in ins if r != src[1]), src[2])
        set_step(si, sources=tuple(srcs))
    elif case == "use_after_evict":
        si, k = next((si, k) for si in bools
                     for k, s in enumerate(plan.steps[si].sources)
                     if s[0] == "clone")
        srcs = list(plan.steps[si].sources)
        srcs[k] = ("clone", 9998)
        set_step(si, sources=tuple(srcs))
    elif case == "clone_clobber":
        si, ks = next((si, ks) for si in bools
                      for ks in [[k for k, s in enumerate(
                          plan.steps[si].sources) if s[0] == "clone"]]
                      if len(ks) >= 2)
        srcs = list(plan.steps[si].sources)
        srcs[ks[1]] = ("clone", int(plan.steps[si].act.rows_l[ks[0]]))
        set_step(si, sources=tuple(srcs))
    elif case == "pin_unknown":
        plan.pins = {"no-such-input": ((3, False),)}
    elif case == "pin_collide":
        plan.pins = {"a": ((5, False),), "b": ((5, False),)}
    elif case == "output_missing":
        plan.steps = [s for s in plan.steps if s.kind != "output"]
    elif case == "log_mismatch":
        plan.writes += 1


@pytest.mark.parametrize("case,name,policy,rule", [
    ("polarity", "maj3", "scheduled", "PLAN-POLARITY"),
    ("row_alias", "xor", "greedy", "PLAN-ROW-ALIAS"),
    ("use_after_evict", "add4", "scheduled", "PLAN-USE-AFTER-EVICT"),
    ("clone_clobber", "add4", "scheduled", "PLAN-CLONE-CLOBBER"),
    ("pin_unknown", "xor", "scheduled", "PLAN-PIN-CONFLICT"),
    ("pin_collide", "xor", "scheduled", "PLAN-PIN-CONFLICT"),
    ("output_missing", "maj3", "greedy", "PLAN-OUTPUT-MISSING"),
    ("log_mismatch", "xor", "greedy", "PLAN-LOG-MISMATCH"),
])
def test_plan_mutation_findings_equal_reference(case, name, policy, rule):
    prog_r, prog_t = RC.get_program(name), TC.get_program(name)
    rplan, tplan = _plans(prog_r, prog_t, policy)
    _mutate(prog_r, rplan, case)
    _mutate(prog_t, tplan, case)
    got = _key(TA.verify_plan(prog_t, tplan))
    assert rule in {f[0] for f in got}
    assert got == _key(RA.verify_plan(prog_r, rplan))


# ---------------------------------------------------------------------------
# verify wiring
# ---------------------------------------------------------------------------
def test_schedule_resident_verify_raises_on_error(monkeypatch):
    prog = TC.get_program("xor")
    bad = [TA.Finding("PLAN-ROW-ALIAS", TA.ERROR, (0,), "injected")]
    monkeypatch.setattr(TA, "verify_plan", lambda *a, **k: bad)
    with pytest.raises(TA.PlanVerificationError) as ei:
        TCC.schedule_resident(prog, _isas()[1], policy="greedy",
                              verify=True)
    assert ei.value.findings == bad
    with pytest.raises(TA.PlanVerificationError):
        TCC.ResidentSession(prog, _isas()[1], verify=True).run(
            {"a": np.ones(64, np.uint8), "b": np.zeros(64, np.uint8)})
    # warnings never raise; verify=False skips the gate entirely
    warn = [TA.Finding("PLAN-LOG-MISMATCH", TA.WARNING, (), "advisory")]
    monkeypatch.setattr(TA, "verify_plan", lambda *a, **k: warn)
    TCC.schedule_resident(prog, _isas()[1], policy="greedy", verify=True)
    monkeypatch.setattr(TA, "verify_plan",
                        lambda *a, **k: pytest.fail("verify=False ran"))
    TCC.schedule_resident(prog, _isas()[1], policy="greedy", verify=False)


@pytest.mark.parametrize("env", [None, "0", "on", "false", "1", " Off ",
                                 ""])
def test_default_verify_tristate_equals_reference(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("FCDRAM_VERIFY", raising=False)
    else:
        monkeypatch.setenv("FCDRAM_VERIFY", env)
    want = RA.default_verify()
    assert TA.default_verify() is want
    assert TConfig().resolved_verify() is want
    assert TConfig().resolved_verify() is RConfig().resolved_verify()
    assert TConfig(verify=True).resolved_verify() is True
    assert TConfig(verify=False).resolved_verify() is False
    if env is None:
        assert want is True     # pytest drives this process


def test_engine_config_verify_validated():
    with pytest.raises(TypeError):
        TConfig(verify="yes")
    assert TConfig().with_(verify=False).verify is False


# ---------------------------------------------------------------------------
# timing lint
# ---------------------------------------------------------------------------
def _both_streams(spec):
    return ([RPrim(*p) for p in spec], [TPrim(*p) for p in spec])


@pytest.mark.parametrize("spec", [
    [(0.0, "ACT", 0, 0), (5.0, "WR", 0, 0)],
    [(0.0, "ACT", 0, 0), (10.0, "PRE", 0, 0)],
    [(0.0, "PRE", 0, 0), (5.0, "ACT", 0, 0)],
    [(0.0, "WR", 0, 0), (5.0, "PRE", 0, 0)],
    [(0.0, "ACT", 0, 0), (1.5, "PRE", 0, 0, "by_design")],
    [(0.0, "ACT", 0, 0), (25.0, "PRE", 0, 0, "deficit")],
    [(0.0, "ACT", 0, 0), (32.0, "PRE", 0, 0), (46.25, "ACT", 0, 0)],
], ids=["trcd", "tras", "trp", "twr", "by_design", "deficit", "boundary"])
def test_timing_checker_report_equal(spec):
    rt, tt = _T()
    rs, ts = _both_streams(spec)
    got = dataclasses.asdict(TA.TimingChecker(tt).lint(ts))
    assert got == dataclasses.asdict(RA.TimingChecker(rt).lint(rs))


def test_ddr4_rules_and_expand_log_equal():
    rt, tt = _T()
    assert [dataclasses.astuple(r) for r in TA.ddr4_rules(tt)] == \
        [dataclasses.astuple(r) for r in RA.ddr4_rules(rt)]
    logs = (RLog(), TLog())
    for log in logs:
        log.add("WR", 30.0, 50.0, count=2, bank=1, sub=0)
        log.add("APA", 36.25, 9.0, bank=1, sub=2)
        log.add("APA+WR", 30.0, 9.0, bank=1, sub=2)
    for kw in ({}, {"bank": 7}, {"t0": 100.0}):
        assert [dataclasses.astuple(p)
                for p in TA.expand_log(logs[1], tt, **kw)] == \
            [dataclasses.astuple(p) for p in RA.expand_log(logs[0], rt, **kw)]


def _run_both(name, seed=4, policy="scheduled", trials=None):
    ri, ti = _isas(trials=trials, seed=seed)
    prog_r, prog_t = RC.get_program(name), TC.get_program(name)
    rng = np.random.default_rng(seed)
    names = sorted({i.name for i in prog_r.instrs if i.op == "input"})
    ins = {n: rng.integers(0, 2, (ri.width,), dtype=np.uint8)
           for n in names}
    RCC.run_sim(prog_r, ins, ri, resident=RP(policy))
    TCC.run_sim(prog_t, ins, ti, resident=TP(policy))
    return ri, ti


@pytest.mark.parametrize("policy", ("host",) + POLICIES)
@pytest.mark.parametrize("name", RC.PROGRAMS)
def test_sim_log_lint_equal_and_clean(name, policy):
    ri, ti = _run_both(name, policy=policy)
    got = TA.TimingChecker(ti.sim.module).lint(ti.sim.log)
    assert got.total_violations == 0 and sum(got.by_design.values()) > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(
        RA.TimingChecker(ri.sim.module).lint(ri.sim.log))


def _xor_arrays(banks=4, seed=0):
    """The same xor run on every bank of a reference and a port array."""
    arrs = (RArray(get_module(), banks=banks, seed=seed, error_model="ideal"),
            TArray(get_module(), banks=banks, seed=seed, error_model="ideal",
                   device="cpu"))
    rng = np.random.default_rng(2)
    for b in range(banks):
        ins = {n: rng.integers(0, 2, (arrs[0].isa(b).width,),
                               dtype=np.uint8) for n in ("a", "b")}
        RCC.run_sim(RC.get_program("xor"), ins, arrs[0].isa(b),
                    resident=RP.SCHEDULED)
        TCC.run_sim(TC.get_program("xor"), ins, arrs[1].isa(b),
                    resident=TP.SCHEDULED)
    return arrs


def _array_report(rep):
    d = dataclasses.asdict(rep)
    return d | {"violations": rep.violations,
                "optimism_pct": rep.optimism_pct}


@pytest.mark.parametrize("banks", [1, 2, 4])
def test_lint_bank_array_equal(banks):
    ra, ta = _xor_arrays(banks)
    got = TA.lint_bank_array(ta)
    assert got.violations == 0
    if banks == 4:              # 8 ACTs collide inside one tFAW at t=0
        assert got.trrd_conflicts > 0 and got.tfaw_conflicts > 0
    assert got.min_legal_makespan_ns >= got.makespan_ns
    assert _array_report(got) == _array_report(RA.lint_bank_array(ra))


@pytest.mark.parametrize("spec", [
    [(0.0, 1), (1.5, 0), (2.0, 0)],         # non-adjacent tRRD
    [(0.0, 0), (0.1, 1), (0.2, 2)],         # once per arriving ACT
    [(i * 3.75, 0) for i in range(6)],      # single-bank burst: no tFAW
    [(i * 3.75, i % 2) for i in range(6)] + [(60.0, 1)],
], ids=["nonadjacent", "once_per_act", "single_bank", "mixed_slide"])
def test_rank_conflicts_equal(spec):
    rt, tt = _T()
    rs, ts = _both_streams([(t, "ACT", b, 0) for t, b in spec])
    assert TA.rank_conflicts(ts, tt) == RA.rank_conflicts(rs, rt)


def test_act_rate_bound_and_report_merge_equal():
    rt, tt = _T()
    for n in (0, 1, 4, 5, 13, 100):
        assert TA.act_rate_bound(n, tt) == RA.act_rate_bound(n, rt)
    merged = []
    for pkg in (RA, TA):
        reps = [pkg.TimingReport(span_ns=s, trefi_ns=rt.tREFI,
                                 refresh_debt=1, violations={"X": 1})
                for s in (1.5 * rt.tREFI, 0.5 * rt.tREFI, 2.2 * rt.tREFI)]
        for r in reps[1:]:
            reps[0].merge(r)
        legacy = pkg.TimingReport(span_ns=100.0, refresh_debt=2).merge(
            pkg.TimingReport(span_ns=90.0, refresh_debt=1))
        merged.append((dataclasses.asdict(reps[0]),
                       dataclasses.asdict(legacy)))
    assert merged[0] == merged[1]


# ---------------------------------------------------------------------------
# rank-legal scheduler
# ---------------------------------------------------------------------------
def _durations(t):
    from repro.core.device import VIOLATED_TRAS_NS, VIOLATED_TRP_NS
    return {"WR": t.tRCD + t.tWR + t.tRP, "RD": t.tRCD + t.tCL + t.tRP,
            "FRAC": 2 * (VIOLATED_TRAS_NS + t.tRP),
            "RC": t.tRAS + VIOLATED_TRP_NS + t.tRAS + t.tRP,
            "APA": VIOLATED_TRAS_NS + VIOLATED_TRP_NS + t.tRAS + t.tRP}


def _mixes(case):
    """Per-bank command lists: deterministic cases, then seeded random
    mixes of 1-4 banks (tests/test_schedule.py's property inputs)."""
    t = timings_for(get_module())
    if case == "serial":
        return {0: ["WR", "WR", "APA", "RD"]}
    if case == "refresh":
        return {0: ["WR"] * (int(2.5 * t.tREFI / _durations(t)["WR"]) + 1)}
    if case == "contention":
        return {b: ["APA"] * 6 for b in range(4)}
    if case == "empty":
        return {}
    rng = np.random.default_rng(case)
    return {b: [CMDS[i] for i in rng.integers(0, 5, rng.integers(1, 13))]
            for b in range(int(rng.integers(1, 5)))}


def _timeline(tl):
    return {
        "legal": tl.legal_makespan_ns, "serial": tl.serial_makespan_ns,
        "min": tl.min_legal_makespan_ns, "acts": tl.n_acts,
        "relint": tl.relint_violations, "refresh": tl.refresh_windows,
        "rank_stall": tl.rank_stall_ns, "ref_stall": tl.refresh_stall_ns,
        "overhead": tl.legality_overhead_pct,
        "per_bank": {b: dataclasses.astuple(bt)
                     for b, bt in tl.per_bank.items()},
        "commands": [(c.start, c.block.cmd, c.block.bank, c.rank_stall_ns,
                      c.refresh_stall_ns) for c in tl.commands],
    }


@pytest.mark.parametrize("case", ["serial", "refresh", "contention",
                                  "empty", *range(6)])
def test_schedule_blocks_equal_reference(case):
    from repro.analysis.schedule import command_blocks as r_blocks
    from repro.analysis.schedule import schedule_blocks as r_schedule
    from repro_torch.analysis.schedule import command_blocks as t_blocks
    from repro_torch.analysis.schedule import schedule_blocks as t_schedule
    rt, tt = _T()
    per_bank = {}
    for pkg, log_cls, blocks, t in ((0, RLog, r_blocks, rt),
                                    (1, TLog, t_blocks, tt)):
        per_bank[pkg] = {}
        for b, cmds in _mixes(case).items():
            log = log_cls()
            for c in cmds:
                log.add(c, _durations(t)[c], 1.0, bank=b)
            per_bank[pkg][b] = blocks(log, t, bank=b)
    got = t_schedule(per_bank[1], tt)
    assert got.relint_violations == 0 and got.relint() == 0
    assert got.legal_makespan_ns >= got.min_legal_makespan_ns - 1e-6
    if case == "refresh":
        assert got.refreshes >= 2
    if case == "contention":
        assert got.rank_stall_ns > 0.0
    assert _timeline(got) == _timeline(r_schedule(per_bank[0], rt))


@pytest.mark.parametrize("banks", [1, 2, 4])
def test_schedule_bank_array_and_legal_makespan_equal(banks):
    ra, ta = _xor_arrays(banks)
    got = TA.schedule_bank_array(ta)
    assert got.relint() == 0
    assert got.legal_makespan_ns >= ta.makespan_ns()
    assert _timeline(got) == _timeline(RA.schedule_bank_array(ra))
    assert ta.legal_makespan_ns() == ra.legal_makespan_ns()


def test_engine_schedule_timing_equals_reference():
    eng = TEngine("dram", banks=2, resident=TP.SCHEDULED, verify=True,
                  device="cpu")
    ref_eng = REngine("dram", banks=2, resident=RP.SCHEDULED, verify=True,
                      fused=False)
    rng = np.random.default_rng(7)
    ins = {k: rng.integers(0, 2 ** 32, (4, 4), dtype=np.uint32)
           for k in ("a", "b")}
    eng.run_program(TC.get_program("xor"), ins)
    ref_eng.run_program(RC.get_program("xor"), ins)
    tl = eng.schedule_timing()
    assert tl.relint() == 0
    assert _timeline(tl) == _timeline(ref_eng.schedule_timing())
    rep = eng.report
    assert rep.legal_makespan_ns == tl.legal_makespan_ns
    assert rep.legal_makespan_ns >= rep.makespan_ns > 0.0
    assert rep.summary() == ref_eng.report.summary()
    with pytest.raises(RuntimeError):
        TEngine("torch", device="cpu").schedule_timing()


@pytest.mark.parametrize("fused", [False, None])
@pytest.mark.parametrize("call", ["nand16", "not1", "add4_scheduled",
                                  "xor_host"])
@pytest.mark.parametrize("banks", [1, 4])
def test_mc_stats_equal_reference(call, banks, fused):
    """``stats=`` after the per-bank loop (``fused=False``) or the default
    (which fuses the 4-bank host-staged sweeps): the modeled timing dict
    equals the reference's under the same setting, numpy draws."""
    kw = dict(trials=36, row_bits=512, seed=1, banks=banks, fused=fused)
    got, want = {}, {}
    if call == "nand16":
        a = TC.mc_boolean_success("nand", 16, stats=got, **kw, **NP)
        b = RC.mc_boolean_success("nand", 16, stats=want, **kw)
    elif call == "not1":
        a = TC.mc_not_success(1, stats=got, **kw, **NP)
        b = RC.mc_not_success(1, stats=want, **kw)
    else:
        name, pol = call.split("_")
        a = TC.mc_program_success(name, resident=TP(pol), stats=got, **kw,
                                  **NP)
        b = RC.mc_program_success(name, resident=RP(pol), stats=want, **kw)
    assert a == b
    assert got["legal_makespan_ns"] >= got["makespan_ns"] > 0.0
    assert got == want
