"""The port's calibration, reliability planning and the rest of the
characterization against the reference package (CPU).

Mirrors ``tests/test_analog.py``'s calibration tests, the ``plan`` paths
of ``tests/test_resident.py``, the plumbing of ``tests/test_workloads.py``
(the workload zoo compiles and verifies, the independent-op estimate,
``plan_workload``, the MC bounds) and ``tests/test_simulator.py``'s
``apa_then_write``; then every figure driver, ``observation3_perfect_cells``
and ``takeaway_tables``.

Tolerances: exact equality with the reference for the closed forms (the
port's ``analog`` / ``calibrate`` are copies, so float results are bit
for bit), for command logs, for ideal mode and for the Monte-Carlo under
``draws="numpy"`` on the CPU (Obs. 3's mean over the cell map: 1e-12
relative, the float64 summation order); the headline-claim and
MC-contract bounds are the reference tests' own.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import analog as RAn
from repro.core import calibrate as RCal
from repro.core import charz as RC
from repro.core import compiler as RCC
from repro.core import reliability as RR
from repro.core.isa import inventory_for
from repro.core.simulator import BankSim as RSim
from repro_torch import analysis as TA
from repro_torch.core import analog as TAn
from repro_torch.core import calibrate as TCal
from repro_torch.core import charz as TC
from repro_torch.core import compiler as TCC
from repro_torch.core import reliability as TR
from repro_torch.core.simulator import BankSim as TSim

NP = dict(draws="numpy", device="cpu")
OPS = ("and", "nand", "or", "nor")
NS = (2, 4, 8, 16)


@pytest.fixture(autouse=True)
def _fresh_schedule_caches():
    RCC._SCHED_CACHE.clear()
    TCC._SCHED_CACHE.clear()
    yield


def _tuple(plan):
    return dataclasses.astuple(plan)


# ---------------------------------------------------------------------------
# calibration (tests/test_analog.py), bit for bit with the reference
# ---------------------------------------------------------------------------
def _perturbed(an):
    """DEFAULT_PARAMS moved off the fit by a fixed, seeded step."""
    cal = TCal if an is TAn else RCal
    v = cal.params_to_vec(an.DEFAULT_PARAMS)
    step = np.random.default_rng(3).normal(0.0, 0.05, v.shape)
    return cal.vec_to_params(v + step, an.DEFAULT_PARAMS)


@pytest.mark.parametrize("where", ["default", "perturbed"])
def test_calibration_terms_equal_reference(where):
    pt = TAn.DEFAULT_PARAMS if where == "default" else _perturbed(TAn)
    pr = RAn.DEFAULT_PARAMS if where == "default" else _perturbed(RAn)
    assert TCal.residuals(pt) == RCal.residuals(pr)
    assert TCal.loss(pt) == RCal.loss(pr)
    assert TCal.monotonicity_penalty(pt) == RCal.monotonicity_penalty(pr)
    assert TCal.bounds_penalty(pt) == RCal.bounds_penalty(pr)
    assert np.array_equal(TCal.params_to_vec(pt), RCal.params_to_vec(pr))


def test_calibration_scorecard_equals_reference():
    """BENCH_pr10.json's calibration: 37 claims, 25 within 1.5 pts."""
    res = TCal.residuals(TAn.DEFAULT_PARAMS)
    assert len(res) == 37
    assert sum(1 for _p, _m, d in res.values() if abs(d) <= 1.5) == 25
    assert TCal.report() == RCal.report()
    assert "claim,paper,model,delta" in TCal.report()


@pytest.mark.parametrize("name,tol", [
    ("not.1dst", 1.0), ("not.32dst", 0.5),
    ("op.and16", 1.0), ("op.nand16", 1.0), ("op.or16", 1.0),
    ("op.nor16", 1.0),
    ("not.n2n_advantage", 1.0),
    ("op.and16_minus_and2", 3.5), ("op.or2_minus_and2", 2.5),
    ("not.dist.mid_far", 1.0), ("not.dist.far_close", 1.0),
    ("not.speed.2133_2400", 2.0), ("not.speed.2400_2666", 2.0),
])
def test_headline_claims(name, tol):
    paper, _w, fn = TCal.CLAIMS[name]
    model = fn(TAn.DEFAULT_PARAMS)
    assert abs(model - paper) <= tol, (name, model, paper)
    assert model == RCal.CLAIMS[name][2](RAn.DEFAULT_PARAMS)


def test_all_claims_within_loose_bound_and_monotone():
    known = {"op.die.and2.4gb_a_vs_m"}      # the documented residual
    for name, (_p, _m, delta) in TCal.residuals(TAn.DEFAULT_PARAMS).items():
        assert name in known or abs(delta) <= 10.0, (name, delta)
    assert TCal.monotonicity_penalty(TAn.DEFAULT_PARAMS) == 0.0


def test_nelder_mead_equals_reference():
    f = lambda x: float(np.sum((x - np.arange(len(x))) ** 2)
                        + np.prod(np.cos(x)))
    x0 = np.linspace(-1.0, 1.0, 6)
    xt, ft = TCal.nelder_mead(f, x0, iters=150, seed=4)
    xr, fr = RCal.nelder_mead(f, x0, iters=150, seed=4)
    assert np.array_equal(xt, xr) and ft == fr


def test_fit_small_iters_equals_reference():
    pt = TCal.fit(iters=2, restarts=1)
    pr = RCal.fit(iters=2, restarts=1)
    assert np.array_equal(TCal.params_to_vec(pt), RCal.params_to_vec(pr))
    assert dataclasses.astuple(pt) == dataclasses.astuple(pr)


# ---------------------------------------------------------------------------
# reliability planning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", OPS)
def test_per_op_plans_equal_reference(op):
    for n in NS:
        assert TR.best_regions(op, n) == RR.best_regions(op, n)
        for target in (0.99, 0.999999):
            assert _tuple(TR.plan(op, n, target)) == \
                _tuple(RR.plan(op, n, target))
        assert TR.plan(op, n).overhead == RR.plan(op, n).overhead
        et, er = (m.effective_throughput(op, n, 0.9999)
                  for m in (TR, RR))
        assert _tuple(et.pop("plan")) == _tuple(er.pop("plan"))
        assert et == er


@pytest.mark.parametrize("p_bit", [0.5, 0.9, 0.97, 0.999])
def test_vote_success_equals_reference(p_bit):
    for r in (1, 3, 5, 9):
        assert TR.vote_success(p_bit, r) == RR.vote_success(p_bit, r)
        assert TR.vote_success_with_noisy_vote(p_bit, r, 0.95) == \
            RR.vote_success_with_noisy_vote(p_bit, r, 0.95)


def test_plan_unreachable_target_uses_noisy_vote_fallback():
    target = 1.0 - 1e-12          # unreachable with a noisy vote tree
    pl = TR.plan("and", 2, target, max_replicas=5, noisy_vote=True)
    rc, rr, p_raw = TR.best_regions("and", 2)
    p_vote = TAn.boolean_success_avg("and", 2, compute_region=rc,
                                     ref_region=rr)
    assert pl.replicas == 5
    assert pl.p_final == TR.vote_success_with_noisy_vote(p_raw, 5, p_vote)
    assert _tuple(pl) == _tuple(RR.plan("and", 2, target, max_replicas=5))
    with pytest.raises(ValueError):
        TR.plan(target=0.99)


def test_plan_program_path_pins_to_per_op_answer():
    target = 0.999999
    per_op = TR.plan("and", 2, target)
    single = TCC.compile_expr(TCC.And([TCC.Var("a"), TCC.Var("b")]))
    per_prog = TR.plan(target=target, program=single,
                       mc_success=per_op.p_raw)
    assert per_prog.op == "program:<1 ops>"
    assert (per_prog.replicas, per_prog.p_final, per_prog.ops_total) \
        == (per_op.replicas, per_op.p_final, per_op.ops_total)


@pytest.mark.parametrize("banks", [1, 2])
@pytest.mark.parametrize("program", ["maj3", "add4"])
def test_plan_program_path_backed_by_mc(program, banks):
    """plan(program=) measures the port's mc_program_success (explicit
    draws / device / banks) and equals the reference's plan."""
    kw = dict(trials=27, row_bits=512, seed=3)
    pl = TR.plan(target=0.999999, program=program, banks=banks, **kw, **NP)
    p_raw = TC.mc_program_success(program, banks=banks, **kw, **NP)
    assert pl.p_raw == p_raw
    want = RR.plan(target=0.999999, program=program, **kw) if banks == 1 \
        else None
    if want is not None:
        assert _tuple(pl) == _tuple(want)
    else:
        assert p_raw == RC.mc_program_success(program, banks=banks,
                                              fused=False, **kw)
    n_ops = sum(1 for i in TC.get_program(program).instrs
                if i.op not in ("input", "const"))
    assert pl.op == f"program:{program}" and pl.n == n_ops
    assert pl.ops_total == pl.replicas * n_ops + 4 * (pl.replicas // 2)


def test_plan_workload_replica_choice():
    pl = TR.plan_workload("bloom_probe", target=0.999, mc_success=0.97,
                          noisy_vote=False)
    assert pl.op.startswith("program:bloom_probe")
    assert pl.replicas >= 3 and pl.replicas % 2 == 1
    assert pl.p_final >= 0.999
    assert _tuple(pl) == _tuple(RR.plan_workload(
        "bloom_probe", target=0.999, mc_success=0.97, noisy_vote=False))
    assert _tuple(TR.plan_workload("bloom_probe", fanin=16, mc_success=0.95)) \
        == _tuple(RR.plan_workload("bloom_probe", fanin=16, mc_success=0.95))
    with pytest.raises(ValueError):
        TR.plan_workload("nope")
    with pytest.raises(ValueError):
        TC.mc_workload_success("nope")


@pytest.mark.parametrize("threshold", [0.9, 0.99, 1.0])
def test_cell_mask_on_the_ports_cell_map(threshold):
    m = TC.measure_cell_map("and", 4, trials=40, row_bits=512, **NP)
    r = RC.measure_cell_map("and", 4, trials=40, row_bits=512)
    mask = TR.cell_mask(m, threshold)
    assert isinstance(mask, torch.Tensor) and mask.device == m.device
    assert np.array_equal(mask.numpy(), RR.cell_mask(r, threshold))
    assert TR.usable_fraction(m, threshold) == \
        RR.usable_fraction(r, threshold)
    assert TR.usable_fraction(r, threshold) == \
        RR.usable_fraction(r, threshold)


# ---------------------------------------------------------------------------
# workload programs: estimate, zoo, MC (tests/test_workloads.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", RC.PROGRAMS + RC.WORKLOAD_PROGRAMS
                         + ("bloom_probe16", "bloom_insert16",
                            "dot_bitserial8"))
def test_program_success_estimate_equals_reference(name):
    est = TC.program_success_estimate(name)
    assert 0.0 < est <= 1.0
    assert est == RC.program_success_estimate(name)
    assert TC.program_success_estimate(TC.get_program(name)) == est
    for module in ("hynix_8gb_a_2400", "samsung_8gb_d_2133"):
        assert TC.program_success_estimate(name, module=module,
                                           temp_c=80.0) == \
            RC.program_success_estimate(name, module=module, temp_c=80.0)


def test_workload_zoo_programs_compile_and_verify():
    for name in TC.WORKLOAD_PROGRAMS:
        prog = TC.get_program(name)
        assert not TA.verify_program(prog)
        assert TC.get_program(f"{name}8").stats()


@pytest.mark.parametrize("workload", RC.WORKLOAD_PROGRAMS)
def test_mc_workload_success_equals_reference(workload):
    kw = dict(trials=18, row_bits=512, seed=1)
    for fanin in (None, 2):
        assert TC.mc_workload_success(workload, fanin=fanin, **kw, **NP) \
            == RC.mc_workload_success(workload, fanin=fanin, **kw)


def test_workload_fanin_sweep_equals_reference():
    kw = dict(trials=18, row_bits=512, temp_c=60.0)
    got = TC.workload_fanin_sweep(fanins=(2, 4, 8, 16), **kw, **NP)
    assert got == RC.workload_fanin_sweep(fanins=(2, 4, 8, 16), **kw)
    assert set(got) == {f"{w}{n}" for w in ("bloom_probe", "bloom_insert")
                        for n in (2, 4, 8, 16)}


def test_workload_success_bounded_by_op_composition():
    """The reliability.plan contract (tests/test_workloads.py, at its CI
    trial count): measured whole-program success is no worse than the
    independent-op composition, and below 1 under noise."""
    for name in ("bloom_probe", "dot_bitserial"):
        est = TC.program_success_estimate(name)
        mc = TC.mc_workload_success(name, trials=40, seed=0, **NP)
        assert mc == RC.mc_workload_success(name, trials=40, seed=0)
        assert est - 0.05 <= mc < 1.0, (name, mc, est)


def test_bloom_probe_success_monotone_in_fanin():
    s2, s16 = (TC.mc_workload_success("bloom_probe", fanin=n, trials=40,
                                      seed=0, **NP) for n in (2, 16))
    assert s16 >= s2 - 0.02, (s2, s16)


def test_new_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    for call in (lambda: TC.workload_fanin_sweep(fanins=(2,), trials=2),
                 lambda: TC.mc_workload_success("bloom_probe", trials=2),
                 lambda: TC.observation3_perfect_cells(trials=2),
                 lambda: TR.plan(target=0.9, program="xor", trials=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# BankSim.apa_then_write (tests/test_simulator.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("trials", [None, 3])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_apa_then_write_equals_reference(trials, as_tensor):
    """§4.2: the exact pattern in every R_F row, its complement in the
    shared half of every R_L row; rows and log equal to the reference."""
    kw = dict(row_bits=64, error_model="ideal", seed=3, trials=trials)
    rs, ts = RSim(**kw), TSim(**kw, device="cpu")
    inv = inventory_for(rs.module, rs.seed)
    pattern = np.random.default_rng(5).integers(0, 2, 64).astype(np.float32)
    acts = []
    for k, (nf, nl) in enumerate(((4, 4), (2, 2), (8, 8))):
        rf, rl = inv.choose(nf, nl, k)
        acts.append(rs.apa_then_write(rs.global_addr(0, rf),
                                      rs.global_addr(1, rl), pattern))
        got = ts.apa_then_write(
            ts.global_addr(0, rf), ts.global_addr(1, rl),
            torch.from_numpy(pattern) if as_tensor else pattern)
        assert (got.n_rf, got.n_rl) == (acts[-1].n_rf, acts[-1].n_rl)
    _lo, _f, l_cols = rs._split_cols(0, 1)
    for act in acts:
        for r in act.rows_f:
            got = ts.read_row(0, int(r)).numpy()
            assert np.array_equal(got, rs.read_row(0, int(r)))
            assert np.array_equal(got[..., :], np.broadcast_to(
                pattern.astype(np.uint8), got.shape))
        for r in act.rows_l:
            got = ts.read_row(1, int(r)).numpy()
            assert np.array_equal(got, rs.read_row(1, int(r)))
            assert np.array_equal(got[..., l_cols],
                                  np.broadcast_to(1 - pattern.astype(
                                      np.uint8)[l_cols],
                                      got[..., l_cols].shape))
    ev = lambda s: [(e.cmd, e.t_ns, e.e_pj, e.count, e.bank, e.sub)
                    for e in s.log.events]
    assert ev(ts) == ev(rs) and ts.log.counts == rs.log.counts
    assert ts.log.time_ns == rs.log.time_ns


# ---------------------------------------------------------------------------
# figure drivers, Obs. 3, takeaways
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fig", [
    "fig5_activation_coverage", "fig8_not_activation_patterns",
    "fig9_not_distance_heatmap", "fig10_not_temperature", "fig11_not_speed",
    "fig12_not_die_revision", "fig16_k_dependence",
    "fig17_ops_distance_heatmap", "fig18_data_pattern",
    "fig19_ops_temperature", "fig20_ops_speed", "fig21_ops_die_revision",
    "takeaway_tables"])
def test_closed_form_figure_equals_reference(fig):
    assert getattr(TC, fig)() == getattr(RC, fig)()


@pytest.mark.parametrize("module", ["hynix_8gb_a_2400", "samsung_8gb_d_2133"])
def test_fig5_other_modules_equal_reference(module):
    for seed in (0, 3):
        assert TC.fig5_activation_coverage(module, seed=seed) == \
            RC.fig5_activation_coverage(module, seed=seed)


@pytest.mark.parametrize("trials", [70, 130])
def test_observation3_perfect_cells_equals_reference(trials):
    """Counts exact; the mean to float64 rounding (the port sums the map
    on the device in torch's order, the reference in numpy's)."""
    got = TC.observation3_perfect_cells(trials=trials, **NP)
    want = RC.observation3_perfect_cells(trials=trials)
    assert got["mean"] == pytest.approx(want.pop("mean"), rel=1e-12, abs=0)
    assert {k: got[k] for k in want} == want
    assert got["n_cells"] > 0 and 0.0 < got["mean"] < 1.0
