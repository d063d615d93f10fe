"""Port bank-executed programs (CPU) against the reference package.

The compiler's execution half on the torch bank: ``run_sim`` host-staged,
greedy-resident and scheduled-resident, ideal (equal to ``run_ideal`` and
to the reference) and analog under ``draws="numpy"`` (equal to the
reference bit for bit, command logs included); the resident planner's
plans step for step; ``ResidentSession`` chaining; the cross-bank
reduction tree and ``dot_bitserial_tree`` (equal to the reference and to
``popcount_gemm_bits``); the ``dram`` engine's ``run_program`` / ``add``
with their ``OffloadReport``; and ``mc_program_success``.  Inputs are made
with numpy and handed to both packages.  Both packages memoize scheduler
searches per program; every comparison starts from empty caches, so the
two run the same search.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import charz as RC
from repro.core import compiler as RCC
from repro.core.bankarray import BankArray as RArray
from repro.core.isa import CostModel as RCost
from repro.core.isa import PudIsa as RIsa
from repro.core.policy import ResidentPolicy as RP
from repro.core.simulator import BankSim as RSim
from repro.pud import workloads as RW
from repro.pud.engine import PudEngine as REngine
from repro_torch.core import charz as TC
from repro_torch.core import compiler as TCC
from repro_torch.core.bankarray import BankArray as TArray
from repro_torch.core.isa import CostModel as TCost
from repro_torch.core.isa import PudIsa as TIsa
from repro_torch.core.policy import ResidentPolicy as TP
from repro_torch.core.simulator import BankSim as TSim
from repro_torch.kernels import ops as tkops
from repro_torch.pud import workloads as TW
from repro_torch.pud.engine import PudEngine as TEngine

RNG = np.random.default_rng(0)
NP = dict(draws="numpy", device="cpu")
POLICIES = ("host", "greedy", "scheduled")


@pytest.fixture(autouse=True)
def _fresh_schedule_caches():
    RCC._SCHED_CACHE.clear()
    TCC._SCHED_CACHE.clear()
    yield


def _isas(trials, error_model="analog", row_bits=256, seed=5):
    kw = dict(row_bits=row_bits, seed=seed, error_model=error_model,
              trials=trials, track_unshared=trials is None)
    return RIsa(RSim(**kw)), TIsa(TSim(**kw, **NP))


def _inputs(prog, shape) -> dict:
    names = sorted({i.name for i in prog.instrs if i.op == "input"})
    return {n: RNG.integers(0, 2, shape, dtype=np.uint8) for n in names}


def _steps(plan):
    return [(s.kind, s.instr and dataclasses.astuple(s.instr), s.exec_op,
             s.demorgan, s.rf, s.rl, s.pre, s.sources, s.ref_row, s.dup,
             s.name, s.reg, s.where)
            for s in plan.steps]


def _same_log(rsim, tsim) -> bool:
    return (rsim.log.counts == tsim.log.counts
            and rsim.log.time_ns == tsim.log.time_ns
            and rsim.log.energy_pj == tsim.log.energy_pj)


def _same_out(ref: dict, port: dict) -> bool:
    return ref.keys() == port.keys() and all(
        np.array_equal(np.asarray(ref[k]), port[k].cpu().numpy())
        for k in ref)


# ---------------------------------------------------------------------------
# run_sim and the resident planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", TC.PROGRAMS)
def test_run_sim_ideal_equals_run_ideal_and_reference(name, policy):
    rprog, tprog = RC.get_program(name), TC.get_program(name)
    ri, ti = _isas(6, "ideal")
    ins = _inputs(tprog, (6, 128))
    got = TCC.run_sim(tprog, ins, ti, resident=TP(policy))
    want = TCC.run_ideal(tprog, ins, width=128)
    assert _same_out(want, got)
    assert _same_out(RCC.run_sim(rprog, ins, ri, resident=RP(policy)), got)
    assert _same_log(ri.sim, ti.sim)
    # the oracle on tensors gives the same bits as on numpy arrays
    tens = TCC.run_ideal(tprog, {k: torch.from_numpy(v)
                                 for k, v in ins.items()}, width=128)
    assert _same_out(want, tens)


@pytest.mark.parametrize("trials", [None, 6])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", TC.PROGRAMS)
def test_run_sim_analog_equals_reference(name, policy, trials):
    """Noisy bank, numpy draws: outputs, command logs and ISA counters
    equal the reference's (scalar and trial-batched)."""
    rprog, tprog = RC.get_program(name), TC.get_program(name)
    ri, ti = _isas(trials)
    ins = _inputs(tprog, (128,) if trials is None else (trials, 128))
    want = RCC.run_sim(rprog, ins, ri, resident=RP(policy))
    got = TCC.run_sim(tprog, ins, ti, resident=TP(policy))
    assert _same_out(want, got)
    assert _same_log(ri.sim, ti.sim)
    rs, ts = dataclasses.asdict(ri.stats), dataclasses.asdict(ti.stats)
    assert rs == ts


def test_run_sim_per_trial_reference_path():
    prog_r, prog_t = RC.get_program("maj3"), TC.get_program("maj3")
    ri, ti = _isas(None)
    ins = _inputs(prog_t, (4, 128))
    want = RCC.run_sim(prog_r, ins, ri, trials=4, batched=False)
    got = TCC.run_sim(prog_t, ins, ti, trials=4, batched=False)
    assert got["out"].shape == (4, 128)
    assert _same_out(want, got) and _same_log(ri.sim, ti.sim)


@pytest.mark.parametrize("policy", ["greedy", "scheduled"])
@pytest.mark.parametrize("name", ["xor", "add4", "dot_bitserial6",
                                  "bloom_insert4"])
def test_plans_equal_reference(name, policy):
    """Same program, same bank: the same plan step for step, the same
    command counts and the same static cost, which equals the measured
    command log of its mechanical execution."""
    rprog, tprog = RC.get_program(name), TC.get_program(name)
    ri, ti = _isas(None, "ideal", row_bits=512)
    rplan = RCC.schedule_resident(rprog, ri, policy=policy, verify=False)
    tplan = TCC.schedule_resident(tprog, ti, policy=policy)
    assert _steps(tplan) == _steps(rplan)
    assert tplan.command_counts() == rplan.command_counts()
    for f in ("order", "demorgan", "assignments", "carry", "pins",
              "duplications", "spill_demand", "dup_hints", "dup_enabled",
              "acts", "polarity_spills"):
        assert getattr(tplan, f) == getattr(rplan, f), f
    assert dataclasses.astuple(tprog.cost(plan=tplan)) == \
        dataclasses.astuple(rprog.cost(plan=rplan))
    assert tplan.expected_log() == rplan.expected_log()
    assert tplan.staged_bytes() == rplan.staged_bytes()
    assert ti._pair_cursor == ri._pair_cursor
    t0, e0 = ti.sim.log.time_ns, ti.sim.log.energy_pj
    TCC.run_sim(tprog, _inputs(tprog, (256,)), ti,
                resident=TP(policy), plan=tplan)
    assert sum(tplan.command_counts().values()) == \
        tprog.cost(plan=tplan).commands
    assert tplan.expected_log() == pytest.approx(
        (ti.sim.log.time_ns - t0, ti.sim.log.energy_pj - e0), rel=1e-12)


def test_resident_session_reuse():
    """Two chained blocks: equal outputs, fewer host writes on the second
    pass (const carry + pinned inputs), plans equal to the reference's."""
    prog_r, prog_t = RC.get_program("add4"), TC.get_program("add4")
    ri, ti = _isas(4, "ideal")
    ins = _inputs(prog_t, (4, 128))
    rs = RCC.ResidentSession(prog_r, ri, policy="scheduled", verify=False)
    ts = TCC.ResidentSession(prog_t, ti, policy="scheduled")
    outs = [ts.run(ins) for _ in range(2)]
    for _ in range(2):
        rs.run(ins)
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    assert _same_out(TCC.run_ideal(prog_t, ins, width=128), outs[1])
    assert ts.plans[1].writes < ts.plans[0].writes
    for rp, tp in zip(rs.plans, ts.plans, strict=True):
        assert _steps(tp) == _steps(rp)
    assert _same_log(ri.sim, ti.sim)
    assert ti.last_resident_plan is ts.plans[-1]


def test_verify_true_raises_and_none_plans(monkeypatch):
    """``verify=True`` raises ``PlanVerificationError`` when the verifier
    reports an ERROR (here injected) and plans when it reports none; every
    tri-state value plans a clean program."""
    from repro_torch import analysis
    prog = TC.get_program("xor")
    _ri, ti = _isas(None, "ideal")
    for v in (True, None, False):
        assert TCC.schedule_resident(prog, ti, verify=v).apas == 4
    bad = [analysis.Finding("PLAN-ROW-ALIAS", analysis.ERROR, (0,), "")]
    monkeypatch.setattr(analysis, "verify_plan", lambda *a, **k: bad)
    with pytest.raises(analysis.PlanVerificationError):
        TCC.schedule_resident(prog, ti, verify=True)
    with pytest.raises(analysis.PlanVerificationError):
        TCC.ResidentSession(prog, ti, verify=True).run(
            {"a": np.ones(ti.width, np.uint8),
             "b": np.ones(ti.width, np.uint8)})
    assert TCC.schedule_resident(prog, ti, verify=False).apas == 4


def test_cost_model_twins_equal_reference():
    for rb in (None, 64, 2048):
        r, t = RCost(row_bits=rb), TCost(row_bits=rb)
        for fn in ("log_write", "log_read", "log_rowclone", "log_frac"):
            assert getattr(t, fn)() == getattr(r, fn)(), fn
        for n in (2, 5, 32):
            assert t.log_apa(n) == r.log_apa(n)
            assert t.log_apa(n, first_restored=True) == \
                r.log_apa(n, first_restored=True)
            assert t.io_adjustment(n) == r.io_adjustment(n)
    ri, ti = _isas(None)
    assert ti.inv.coverage(2, 2) == ri.inv.coverage(2, 2)
    c = TCost().boolean(4)
    assert (c.metric("energy"), c.metric("latency")) == \
        (c.energy_pj, c.time_ns)
    with pytest.raises(ValueError):
        c.metric("power")


# ---------------------------------------------------------------------------
# Cross-bank reduction tree, dot_bitserial_tree
# ---------------------------------------------------------------------------
def test_bankarray_addressing():
    arr = TArray(banks=3, row_bits=128, error_model="ideal", seed=7,
                 device="cpu")
    assert arr.shard(7) == RArray(banks=3, row_bits=128,
                                  error_model="ideal", seed=7).shard(7)
    assert arr[1] is arr.isa(1) and arr.isas == [arr.isa(b)
                                                for b in range(3)]


def test_tree_reduce_add_and_popcount_equal_reference():
    kw = dict(banks=3, row_bits=256, seed=4, error_model="analog",
              trials=3, track_unshared=False)
    ra, ta = RArray(**kw), TArray(**kw, **NP)
    ops = [RNG.integers(0, 2, (k, 3, 128), dtype=np.uint8) for k in (2, 3, 1)]
    want, wb = ra.tree_reduce_add(ops)
    got, gb = ta.tree_reduce_add(ops)
    assert gb == wb and np.array_equal(got.numpy(), want)
    bits = [RNG.integers(0, 2, (n, 3, 128), dtype=np.uint8) for n in (3, 0, 4)]
    want, wb = ra.popcount(bits)
    got, gb = ta.popcount(bits)
    assert gb == wb and np.array_equal(got.numpy(), want)
    assert ta.bank_time_ns() == ra.bank_time_ns()
    for b in range(3):
        assert _same_log(ra.isa(b).sim, ta.isa(b).sim)


@pytest.mark.parametrize("noisy", [False, True])
def test_dot_bitserial_tree_equals_reference(noisy):
    x = RNG.integers(0, 2, (4, 9), dtype=np.uint8)
    w = RNG.integers(0, 2, (5, 9), dtype=np.uint8)
    got, arr = TW.dot_bitserial_tree(x, w, banks=3, row_bits=2048,
                                     noisy=noisy, **NP)
    want, rarr = RW.dot_bitserial_tree(x, w, banks=3, row_bits=2048,
                                       noisy=noisy)
    assert got.dtype == torch.int32 and got.shape == (4, 5)
    assert np.array_equal(got.numpy(), want)
    assert arr.bank_time_ns() == rarr.bank_time_ns()
    if not noisy:
        assert torch.equal(got, tkops.popcount_gemm_bits(x, w, device="cpu"))


# ---------------------------------------------------------------------------
# The dram engine's run_program / add
# ---------------------------------------------------------------------------
def _planes(*shape) -> np.ndarray:
    return RNG.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().view(np.uint32)
    return np.asarray(x)


def _same_reports(eng, ref_eng) -> None:
    assert eng.report.summary() == ref_eng.report.summary()
    assert sorted(eng.report.banks) == sorted(ref_eng.report.banks)
    for b in eng.report.banks:
        for f in ("dram", "rowclones", "staged_bytes"):
            tv, rv = (getattr(r.report.bank(b), f) for r in (eng, ref_eng))
            if f == "dram":
                tv, rv = dataclasses.astuple(tv), dataclasses.astuple(rv)
            assert tv == rv, (b, f)


@pytest.mark.parametrize("banks", [1, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_dram_run_program_and_add_equal_reference(policy, banks):
    """Noisy, seed 3: an 8-chunk dot program (4 blocks of 2, a broadcast
    operand among them) and a one-chunk adder, bit for bit, with the
    offload report equal field for field (per bank too)."""
    eng = TEngine("dram", noisy=True, seed=3, banks=banks,
                  resident=TP(policy), **NP)
    ref_eng = REngine("dram", noisy=True, seed=3, banks=banks,
                      resident=RP(policy),
                      fused=False if banks > 1 else None)
    prog_t, prog_r = TW.dot_program(3), RW.dot_program(3)
    planes = {f"{c}{i}": _planes(4, 256) for c in "ab" for i in range(3)}
    planes["b1"] = np.tile(_planes(1, 128), (4, 2))   # one 4096-bit word
    got = eng.run_program(prog_t, planes)
    want = ref_eng.run_program(prog_r, planes)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(_u32(got[k]), _u32(want[k])), k
    a, b = _planes(3, 1, 64), _planes(3, 1, 64)
    assert np.array_equal(_u32(eng.add(a, b)), _u32(ref_eng.add(a, b)))
    _same_reports(eng, ref_eng)


def test_dram_ideal_program_equals_kernel_backend():
    prog = TW.dot_program(4)
    planes = {f"{c}{i}": _planes(2, 128) for c in "ab" for i in range(4)}
    got = TEngine("dram", banks=2, device="cpu").run_program(prog, planes)
    want = TEngine("kernel", device="cpu").run_program(prog, planes)
    assert all(torch.equal(got[k], want[k]) for k in want)
    a, b = _planes(4, 2, 128), _planes(4, 2, 128)
    assert torch.equal(TEngine("dram", device="cpu").add(a, b),
                       TEngine("kernel", device="cpu").add(a, b))


# ---------------------------------------------------------------------------
# Program-level Monte-Carlo
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("banks", [1, 2])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", TC.PROGRAMS)
def test_mc_program_success_equals_reference(name, policy, banks):
    kw = dict(trials=18, row_bits=512, seed=2, banks=banks)
    want = RC.mc_program_success(name, resident=RP(policy),
                                 fused=False if banks > 1 else None, **kw)
    got = TC.mc_program_success(name, resident=TP(policy), **kw, **NP)
    assert got == want


def test_mc_program_success_per_trial_and_options():
    kw = dict(trials=3, row_bits=512, seed=1, batched=False)
    assert TC.mc_program_success("xor", **kw, **NP) == \
        RC.mc_program_success("xor", **kw)
    with pytest.raises(ValueError):
        TC.mc_program_success("xor", resident=TP.GREEDY, batched=False,
                              device="cpu")
    with pytest.raises(NotImplementedError):
        TC.mc_program_success("xor", banks=2, fused=True, device="cpu")
    with pytest.raises(ValueError):
        TC.get_program("nope")
    for name in ("bloom_probe8", "bloom_insert", "dot_bitserial5", "add3"):
        assert TC.get_program(name).stats() == \
            RC.get_program(name).stats()
