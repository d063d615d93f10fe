"""Port fused bank axis (CPU) against the per-bank loop and the reference.

Mirrors ``tests/test_fused.py`` case for case on ``repro_torch.core.fused``:

* a ``FusedPudIsa`` episode over N banks gives, per bank, exactly the
  results, cell states and command log of the per-bank loop, under
  ``draws="numpy"`` (and then equal to the reference's ``FusedBankSim`` /
  ``FusedPudIsa``) and under ``draws="device"``;
* fusing does not collapse the per-bank noise streams;
* charz ``fused=True`` / ``False`` / default equal the reference's default
  (tail rounds included), and ``_use_fused`` gates as the reference's;
* the ``dram`` engine's fused rounds equal the loop and the reference
  (nary / NOT / the host-staged program; resident programs stay on the
  loop), with the per-bank noise counters and pair cursors after a tail
  round and a second call equal to the reference's;
* config, reseed and ``PerBank`` validation, ``absorb_state``;
* the senseamp plain twin with per-bank ``(N, W)`` / ``(N,)`` planes.

All comparisons are exact unless a test says otherwise.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import charz as RC
from repro.core import compiler as RCC
from repro.core.bankarray import BankArray as RArray
from repro.core.fused import FusedBankSim as RFSim
from repro.core.fused import FusedPudIsa as RFIsa
from repro.core.policy import EngineConfig as REC
from repro.core.policy import ResidentPolicy as RP
from repro_torch import analysis as TA
from repro_torch.core import charz as TC
from repro_torch.core import compiler as TCC
from repro_torch.core.bankarray import BankArray as TArray
from repro_torch.core.fused import (FusedBankSim, FusedExecutionError,
                                    FusedGeometryError, FusedPudIsa, PerBank,
                                    _FusedDraws)
from repro_torch.core.policy import EngineConfig as TEC
from repro_torch.core.policy import ResidentPolicy as TP
from repro_torch.core.simulator import BankSim, _TorchDraws, torch_seed
from repro_torch.kernels import senseamp as S

ROOT = Path(__file__).resolve().parents[1]
NP = dict(draws="numpy", device="cpu")
CPU = dict(device="cpu")
RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _fresh_schedule_caches():
    RCC._SCHED_CACHE.clear()
    TCC._SCHED_CACHE.clear()
    yield


def _log(sim) -> tuple:
    return sim.log.time_ns, sim.log.energy_pj, dict(sim.log.counts)


def _loop_episode(arr, ops_by_bank, not_bits_by_bank):
    """Each bank's own PudIsa runs the same op sequence (the reference's
    ``_loop_episode``)."""
    results, logs = [], []
    for b in range(arr.banks):
        isa = arr.isa(b)
        isa.sim.recycle_rows()
        got1 = isa.nary_op("nand", list(ops_by_bank[b].swapaxes(0, 1)))
        isa.sim.recycle_rows()
        got2 = isa.op_not(not_bits_by_bank[b])
        results.append((np.asarray(got1), np.asarray(got2)))
        logs.append(_log(isa.sim))
    return results, logs


def _fused_episode(fisa, ops_by_bank, bits_by_bank):
    banks = len(ops_by_bank)
    got1 = fisa.nary_op(
        "nand", [np.concatenate([ops_by_bank[b][:, i] for b in range(banks)])
                 for i in range(2)])
    got2 = fisa.op_not(np.concatenate(bits_by_bank))
    return np.asarray(got1), np.asarray(got2)


def _cells(sim, sub) -> np.ndarray:
    c = sim._cells(sub)
    return c.cpu().numpy() if isinstance(c, torch.Tensor) else c


def _episode_inputs(banks, trials, row_bits):
    rng = np.random.default_rng(1000 * banks + 10 * trials + row_bits)
    w = row_bits // 2
    ops = [rng.integers(0, 2, (trials, 2, w)).astype(np.uint8)
           for _ in range(banks)]
    bits = [rng.integers(0, 2, (trials, w)).astype(np.uint8)
            for _ in range(banks)]
    return ops, bits


# ---------------------------------------------------------------------------
# fused == loop, results and command logs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("banks,trials,row_bits", [
    (2, 1, 128), (3, 2, 256), (4, 3, 128), (4, 1, 256)])
def test_fused_matches_loop_and_reference_numpy(banks, trials, row_bits):
    """draws="numpy": per bank, fused == loop (results, logs), and the
    fused episode == the reference's fused episode (results, cell states,
    log, per-bank counters and cursors)."""
    ops, bits = _episode_inputs(banks, trials, row_bits)
    kw = dict(banks=banks, seed=7, row_bits=row_bits, error_model="analog",
              trials=trials, track_unshared=False)
    loop_res, loop_logs = _loop_episode(TArray(**kw, **NP), ops, bits)
    rarr = RArray(**kw)
    fsim = FusedBankSim(rarr.module, bank_seeds=rarr.bank_seeds,
                        trials=trials, row_bits=row_bits,
                        error_model="analog", **NP)
    fisa = FusedPudIsa(fsim)
    got = _fused_episode(fisa, ops, bits)
    flog = _log(fsim)
    for b in range(banks):
        sl = slice(b * trials, (b + 1) * trials)
        assert np.array_equal(loop_res[b][0], got[0][sl]), f"bank {b} nand"
        assert np.array_equal(loop_res[b][1], got[1][sl]), f"bank {b} not"
        # one fused command drives all banks: the fused log equals every
        # per-bank loop log
        assert loop_logs[b] == flog, f"bank {b} log"
    rsim = RFSim(rarr.module, bank_seeds=rarr.bank_seeds, trials=trials,
                 row_bits=row_bits, error_model="analog")
    risa = RFIsa(rsim)
    want = _fused_episode(risa, ops, bits)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert flog == _log(rsim)
    for sub in (0, 1):
        assert np.array_equal(_cells(fsim, sub), _cells(rsim, sub)), sub
    assert fsim._bank_trial == rsim._bank_trial
    assert fisa._bank_cursors == risa._bank_cursors


@pytest.mark.parametrize("banks,trials,row_bits", [(2, 2, 128), (3, 4, 256)])
def test_fused_matches_loop_device_draws(banks, trials, row_bits):
    """draws="device": bank b's torch generator fills slice b, so per bank
    the fused episode == the loop episode bit for bit."""
    ops, bits = _episode_inputs(banks, trials, row_bits)
    arr = TArray(banks=banks, seed=7, row_bits=row_bits,
                 error_model="analog", trials=trials, track_unshared=False,
                 draws="device", **CPU)
    loop_res, loop_logs = _loop_episode(arr, ops, bits)
    fisa = arr.fused_isa()
    got = _fused_episode(fisa, ops, bits)
    for b in range(banks):
        sl = slice(b * trials, (b + 1) * trials)
        assert np.array_equal(loop_res[b][0], got[0][sl]), f"bank {b} nand"
        assert np.array_equal(loop_res[b][1], got[1][sl]), f"bank {b} not"
        assert loop_logs[b] == _log(fisa.sim)


@pytest.mark.parametrize("shape,dtype", [((6, 40), torch.float32),
                                         ((9, 3), torch.float64)])
def test_device_draw_slices_equal_fresh_draws(shape, dtype):
    """A torch draw into a contiguous row slice of a larger buffer == a
    fresh (T_b, w) draw from an identically seeded generator."""
    seqs = [np.random.SeedSequence([s, 0x7A1A1, 1]) for s in (3, 4, 5)]
    t = shape[0]
    fused = _FusedDraws(seqs, t, "device", torch.device("cpu"))
    big = (3 * t,) + shape[1:]
    got_n, got_u = fused.normal(big, dtype), fused.uniform(big, dtype)
    for b, s in enumerate(seqs):
        one = _TorchDraws(torch_seed(s), torch.device("cpu"))
        assert torch.equal(got_n[b * t:(b + 1) * t], one.normal(shape, dtype))
        assert torch.equal(got_u[b * t:(b + 1) * t],
                           one.uniform(shape, dtype))
    with pytest.raises(FusedExecutionError, match="does not stack"):
        fused.normal((3 * t + 1,) + shape[1:], dtype)


@pytest.mark.parametrize("draws", ["numpy", "device"])
def test_fused_noise_streams_pairwise_independent(draws):
    """Fusing the bank axis must not collapse per-bank noise streams."""
    banks, trials = 4, 16
    arr = TArray(banks=banks, seed=3, row_bits=512, error_model="analog",
                 trials=trials, track_unshared=False, draws=draws, **CPU)
    fisa = arr.fused_isa()
    w = fisa.width
    # identical inputs on every bank: per-bank differences are pure noise
    bits = np.tile(np.ones((trials, w), np.uint8), (banks, 1))
    per_bank = fisa.split_banks(fisa.op_not(bits))
    errs = [np.flatnonzero(pb.numpy() != 0) for pb in per_bank]
    assert all(e.size for e in errs), "need visible errors for the test"
    for a in range(banks):
        for b in range(a + 1, banks):
            assert not np.array_equal(errs[a], errs[b]), (a, b)
    assert len(set(fisa.sim.bank_noise_seeds)) == banks


# ---------------------------------------------------------------------------
# charz dispatch
# ---------------------------------------------------------------------------
def _charz(mod, which, **kw):
    if which == "boolean":
        return mod.mc_boolean_success("and", 2, **kw)
    if which == "not":
        return mod.mc_not_success(2, **kw)
    return mod.mc_program_success("xor", **kw)


@pytest.mark.parametrize("which", ["boolean", "not", "program"])
@pytest.mark.parametrize("banks,groups", [(3, 6), (3, 4), (4, 3)])
def test_charz_fused_parity(which, banks, groups):
    """fused=True, fused=False and the default all equal the reference's
    default (which fuses), full and tail rounds alike."""
    kw = dict(trials=12, groups=groups, row_bits=256, banks=banks)
    want = _charz(RC, which, **kw)
    assert want == _charz(RC, which, fused=False, **kw)
    for fused in (True, False, None):
        assert _charz(TC, which, fused=fused, **kw, **NP) == want, fused


@pytest.mark.parametrize("which", ["boolean", "not", "program"])
def test_charz_fused_equals_loop_device_draws(which):
    """draws="device": the fused sweep draws operands and noise exactly as
    the loop does (4 banks, 9 groups: two full rounds and a tail)."""
    kw = dict(trials=27, row_bits=256, banks=4, seed=3, **CPU)
    assert _charz(TC, which, fused=True, **kw) == \
        _charz(TC, which, fused=False, **kw)


@pytest.mark.parametrize("fn", [
    lambda **kw: TC.mc_boolean_success("and", 2, trials=4, **kw),
    lambda **kw: TC.mc_not_success(1, trials=4, **kw),
    lambda **kw: TC.mc_program_success("xor", trials=4, **kw),
])
def test_mc_banks_validation(fn):
    for bad in ("4", True, 2.0):
        with pytest.raises(TypeError, match="banks must be an int"):
            fn(banks=bad, **CPU)
    with pytest.raises(ValueError, match="banks > 1 requires batched"):
        fn(banks=2, batched=False, **CPU)


def test_use_fused_gating():
    for ch in (TC, RC):
        mod = ch.get_module()
        with pytest.raises(ch.FusedGeometryError, match="occupancy"):
            ch._use_fused(True, mod, 2, "occupancy")
        assert ch._use_fused(None, mod, 2, "occupancy") is False
        assert ch._use_fused(None, mod, 1) is False
        assert ch._use_fused(None, mod, 2) is True
        assert ch._use_fused(False, mod, 2) is False
        with pytest.raises(ch.FusedGeometryError, match="resident"):
            ch._use_fused(True, mod, 2, resident=True)
    seq = TC.get_module("samsung_8gb_d_2133")
    with pytest.raises(FusedGeometryError, match="sequentially"):
        TC._use_fused(True, seq, 2)
    assert TC._use_fused(None, seq, 2) is False
    with pytest.raises(FusedGeometryError):
        TC.mc_boolean_success("and", 2, trials=4, banks=2, fused=True,
                              dealer="occupancy", **CPU)
    with pytest.raises(FusedGeometryError):
        TC.mc_program_success("xor", trials=4, banks=2, fused=True,
                              resident=TP.SCHEDULED, **CPU)


@pytest.mark.parametrize("point", ["and16_b4", "not4_b4", "xor_b4"])
def test_fused_charz_matches_committed_benchmark(point):
    """fused=True reproduces the reference's committed multi-bank results
    (BENCH_pr10.json ``fused_detail``: 192 trials, 48 groups, 4 banks)."""
    want = json.loads((ROOT / "BENCH_pr10.json").read_text())[
        "fused_detail"][point]
    kw = dict(trials=want["trials"], groups=want["groups"],
              banks=want["banks"], fused=True, **NP)
    name = point.split("_")[0]
    got = (TC.mc_boolean_success("and", 16, **kw) if name == "and16"
           else TC.mc_not_success(4, **kw) if name == "not4"
           else TC.mc_program_success("xor", **kw))
    assert got == want["loop_success"] == want["fused_success"]


# ---------------------------------------------------------------------------
# dealers
# ---------------------------------------------------------------------------
def test_deal_groups_round_robin_and_errors():
    arr = TArray(banks=3, row_bits=128, error_model="ideal", **CPU)
    assert TC._deal_groups(arr, 7) == [0, 1, 2, 0, 1, 2, 0]
    with pytest.raises(ValueError, match="unknown dealer"):
        TC._deal_groups(arr, 3, "zigzag")
    with pytest.raises(ValueError, match="weights"):
        TC._deal_groups(arr, 3, "occupancy", weights=[1.0])


def test_occupancy_dealer_sees_fused_bank_time():
    """A fused sim's log time accrues to every member bank, so the
    occupancy dealer sees banks 0..k-1 as loaded."""
    arr = TArray(banks=3, row_bits=128, seed=1, error_model="analog",
                 trials=2, track_unshared=False, **CPU)
    fisa = arr.fused_isa(n_banks=2)
    fisa.nary_op("and", np.ones((2, 4, fisa.width), np.uint8))
    t = arr.bank_time_ns()
    assert t[0] == t[1] == fisa.sim.log.time_ns > 0 and t[2] == 0.0
    assert TC._deal_groups(arr, 1, "occupancy") == [2]


# ---------------------------------------------------------------------------
# engine dispatch
# ---------------------------------------------------------------------------
def _planes(r, c):
    return RNG.integers(0, 2 ** 32, (r, c), dtype=np.uint32)


def _u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().view(np.uint32)
    return np.asarray(x)


def _engines(banks, **kw):
    """(port loop, port fused, port default, reference default)."""
    from repro.pud.engine import PudEngine as REngine
    from repro_torch.pud.engine import PudEngine as TEngine
    tkw = {k: (TP(v.value) if isinstance(v, RP) else v)
           for k, v in kw.items()}
    return ([TEngine(TEC(backend="dram", banks=banks, fused=f, **tkw),
                     draws="numpy", **CPU) for f in (False, True, None)]
            + [REngine(REC(backend="dram", banks=banks, **kw))])


def _state(fisas) -> list:
    return [(k, fisa._bank_cursors, fisa.sim._bank_trial)
            for (k, *_), fisa in fisas.items()]


def test_engine_fused_matches_loop_and_reference():
    """(8, 320) planes: 20 chunks in blocks of 5 -> one 3-bank round and a
    1-bank tail round; the second and third calls check the cursors and
    counters carried across the tail."""
    import jax.numpy as jnp
    engines = _engines(3, noisy=True)
    x, y = _planes(8, 320), _planes(8, 320)
    outs = [[], [], [], []]
    for i, e in enumerate(engines):
        pl = jnp.stack([x, y]) if i == 3 else np.stack([x, y])
        xx = jnp.asarray(x) if i == 3 else x
        outs[i] = [_u32(e.nary(pl, "and")), _u32(e.not_(xx)),
                   _u32(e.nary(pl, "nor"))]
    for i in range(3):
        assert all(np.array_equal(a, b) for a, b in zip(outs[i], outs[3])), i
    loop, fused, auto, ref = engines
    assert fused._array._fused and auto._array._fused
    assert not loop._array._fused
    assert _state(fused._array._fused) == _state(ref._array._fused)
    for e in engines[:3]:
        assert e.report.summary() == ref.report.summary()
        for b in ref.report.banks:
            assert dataclasses.astuple(e.report.bank(b).dram) == \
                dataclasses.astuple(ref.report.bank(b).dram)


@pytest.mark.parametrize("pol", [RP.HOST, RP.SCHEDULED])
def test_engine_fused_program_host_and_resident(pol):
    """HOST programs fuse, resident ones stay on the loop; both equal the
    reference's default, report and all."""
    engines = _engines(3, noisy=True, resident=pol)
    prog = {"t": TCC.compile_expr({"o": TCC.Xor(TCC.Var("a"),
                                                TCC.Var("b"))}),
            "r": RCC.compile_expr({"o": RCC.Xor(RCC.Var("a"),
                                                RCC.Var("b"))})}
    a, b = _planes(8, 320), _planes(8, 320)
    outs = [_u32(e.run_program(prog["r" if i == 3 else "t"],
                               {"a": a, "b": b})["o"])
            for i, e in enumerate(engines)]
    for i in range(3):
        assert np.array_equal(outs[i], outs[3]), i
        assert engines[i].report.summary() == engines[3].report.summary()
    fused = engines[1]
    if pol is RP.HOST:
        assert fused._array._fused, "host-policy programs must fuse"
        assert _state(fused._array._fused) == _state(engines[3]._array._fused)
    else:
        assert not fused._array._fused, "resident programs stay on the loop"


def test_engine_fused_config_validation():
    from repro_torch.pud.engine import PudEngine as TEngine
    with pytest.raises(FusedGeometryError, match="banks=1"):
        TEngine(TEC(backend="dram", banks=1, fused=True), **CPU)
    with pytest.raises(FusedGeometryError, match="sequentially"):
        TEngine("dram", banks=2, fused=True, module="samsung_8gb_d_2133",
                **CPU)
    with pytest.raises(ValueError, match="only the dram backend"):
        TEngine(TEC(backend="torch", fused=True), **CPU)
    with pytest.raises(TypeError, match="True/False/None"):
        TEC(backend="dram", banks=2, fused=1)
    # fused=False is allowed anywhere (the loop is the reference everywhere)
    TEngine(TEC(backend="torch", fused=False), **CPU)
    assert TEngine("dram", banks=2, **CPU)._fuse_ok
    assert not TEngine("dram", banks=2, fused=False, **CPU)._fuse_ok


def test_static_analysis_of_fused_engine_equals_reference():
    """The reference's 2-bank fused lint case (xor, HOST, (4, 4) words drawn
    after the loop case's, default_rng(7)): lint and rank schedule equal
    BENCH_pr10.json ``static_detail``.  The 512 bits fill one chunk, so
    nothing stacks: ``fused=True`` runs bank 0's host-staged loop sim, in
    the reference as here."""
    import jax.numpy as jnp
    from repro import analysis as RAn
    from repro.pud.engine import PudEngine as REngine
    from repro_torch.pud.engine import PudEngine as TEngine
    want = json.loads((ROOT / "BENCH_pr10.json").read_text())[
        "static_detail"]
    rng = np.random.default_rng(7)
    for _ in ("a", "b"):      # the loop case's words come first
        rng.integers(0, 2 ** 32, (4, 4), dtype=np.uint32)
    ins = {k: rng.integers(0, 2 ** 32, (4, 4), dtype=np.uint32)
           for k in ("a", "b")}
    eng = TEngine("dram", banks=2, fused=True, resident=TP.HOST,
                  verify=False, **CPU)
    ref = REngine("dram", banks=2, fused=True, resident=RP.HOST,
                  verify=False)
    eng.run_program(TC.get_program("xor"), ins)
    ref.run_program(RC.get_program("xor"),
                    {k: jnp.asarray(v) for k, v in ins.items()})
    assert not eng._array._fused and not ref._array._fused
    rep, rrep = TA.lint_bank_array(eng._array), \
        RAn.lint_bank_array(ref._array)
    tl, rtl = eng.schedule_timing(), ref.schedule_timing()
    got = {"timing_violations": rep.violations,
           "timing_by_design": sum(sum(r.by_design.values())
                                   for r in rep.per_bank),
           "makespan_ns": rep.makespan_ns,
           "min_legal_makespan_ns": rep.min_legal_makespan_ns,
           "legal_makespan_ns": tl.legal_makespan_ns,
           "refresh_stall_ns": tl.refresh_stall_ns,
           "rank_stall_ns": tl.rank_stall_ns,
           "sched_violations": tl.relint_violations}
    assert got == {k: want[f"{k}_fused"] for k in got}
    assert (rep.makespan_ns, rep.min_legal_makespan_ns, tl.legal_makespan_ns,
            tl.n_acts) == (rrep.makespan_ns, rrep.min_legal_makespan_ns,
                           rtl.legal_makespan_ns, rtl.n_acts)
    assert eng._array.bank_time_ns() == ref._array.bank_time_ns()


# ---------------------------------------------------------------------------
# fused core odds and ends
# ---------------------------------------------------------------------------
def test_fused_sim_reseed_wants_one_seed_per_bank():
    arr = TArray(banks=2, row_bits=128, seed=1, error_model="analog",
                 trials=2, track_unshared=False, **CPU)
    fisa = arr.fused_isa()
    with pytest.raises(ValueError, match="one noise seed per bank"):
        fisa.sim.reseed_noise(7)
    fisa.sim.reseed_noise([7, 8])
    assert fisa.sim.bank_noise_seeds == [7, 8]
    with pytest.raises(ValueError, match="need 2 counters"):
        fisa.sim.set_bank_trials([1])
    with pytest.raises(TypeError, match="bank_seeds"):
        FusedBankSim(bank_seeds=[1], trials=1, seed=3, **CPU)
    with pytest.raises(ValueError, match="track_unshared"):
        FusedBankSim(bank_seeds=[1], trials=1, track_unshared=True, **CPU)
    with pytest.raises(TypeError, match="FusedBankSim"):
        FusedPudIsa(BankSim(row_bits=128, **CPU))


def test_perbank_shape_validation():
    arr = TArray(banks=2, row_bits=128, seed=1, error_model="analog",
                 trials=2, track_unshared=False, **CPU)
    fisa = arr.fused_isa()
    with pytest.raises(ValueError, match="PerBank rows"):
        fisa.sim._pb_vals(PerBank(np.zeros((3, 1), np.int64)))
    with pytest.raises(ValueError, match="one .rf, rl. pair per bank"):
        fisa.plan_not(1, pair=[(0, 1), (2, 3), (4, 5)])


def test_absorb_state_roundtrip():
    arr = TArray(banks=3, row_bits=128, seed=2, error_model="analog",
                 trials=2, track_unshared=False, **CPU)
    wide = arr.fused_isa()
    narrow = arr.fused_isa(n_banks=2)
    wide._bank_cursors[0][(2, 1)] = 5
    wide.sim._bank_trial = [4, 5, 6]
    narrow.adopt_state(wide)
    assert narrow._bank_cursors[0][(2, 1)] == 5
    assert narrow.sim._bank_trial == [4, 5]
    narrow._bank_cursors[1][(2, 1)] = 9
    narrow.sim._bank_trial[1] = 11
    wide.absorb_state(narrow)
    assert wide._bank_cursors[1][(2, 1)] == 9
    assert wide.sim._bank_trial == [4, 11, 6]
    with pytest.raises(ValueError, match="narrower"):
        narrow.absorb_state(wide)


def test_lockstep_slot_divergence_raises():
    arr = TArray(banks=2, row_bits=128, seed=2, error_model="ideal",
                 trials=1, track_unshared=False, **CPU)
    sim = arr.fused_isa().sim
    sim._map_rows(0, PerBank([[3], [4]]))
    with pytest.raises(FusedExecutionError, match="first-touch"):
        sim._map_rows(0, PerBank([[3], [5]]))
    sim._map_rows(0, PerBank([[9], [9]]))
    with pytest.raises(FusedExecutionError, match="slot maps diverged"):
        sim._map_rows(0, PerBank([[3], [9]]))


# ---------------------------------------------------------------------------
# the senseamp kernel's per-bank planes (plain twin on the CPU)
# ---------------------------------------------------------------------------
def _gather_case(nb=3, tb=5, slots=7, rb=96, w=48):
    com = torch.from_numpy(RNG.random((nb * tb, slots, rb),
                                      dtype=np.float32))
    ref = torch.from_numpy(RNG.random((nb * tb, slots, rb),
                                      dtype=np.float32))
    args = (com, [6, 1, 4], w, ref, [0, 5], 0)
    nz = torch.from_numpy(RNG.normal(0, 1, (nb * tb, w)).astype(np.float32))
    u0 = torch.from_numpy(RNG.random((nb * tb, w), dtype=np.float32))
    static = torch.from_numpy(RNG.normal(0, .02, (nb, w)).astype(np.float32))
    thr = torch.from_numpy(RNG.normal(0.01, .01, nb).astype(np.float32))
    kw = dict(width=w, u_com=.09, u_ref=.11, normals=nz, sigma=.01, u0=u0,
              pf=.2)
    return args, kw, static, thr, nb, tb


def test_per_bank_planes_equal_expanded_and_per_bank_calls():
    args, kw, static, thr, nb, tb = _gather_case()
    got = S.senseamp_gather_plain(*args, static=static, thr=thr,
                                  bank_trials=tb, **kw)
    # an (N, W) static plane == the (T, W)-expanded plane (scalar thr)
    assert torch.equal(
        S.senseamp_gather_plain(*args, static=static, thr=0.01,
                                bank_trials=tb, **kw),
        S.senseamp_gather_plain(*args, static=static.repeat_interleave(
            tb, dim=0), thr=0.01, **kw))
    # per bank: == that bank's own call with static[b] and thr[b]
    for b in range(nb):
        sl = slice(b * tb, (b + 1) * tb)
        one = (args[0][sl], *args[1:3], args[3][sl], *args[4:])
        kb = dict(kw, normals=kw["normals"][sl], u0=kw["u0"][sl])
        want = S.senseamp_gather_plain(*one, static=static[b],
                                       thr=float(thr[b]), **kb)
        assert torch.equal(got[sl], want), b
    # N = 1 is the unfused call
    assert torch.equal(
        S.senseamp_gather_plain(*args, static=static[0], thr=float(thr[0]),
                                **kw),
        S.senseamp_gather_plain(*args, static=static[:1], thr=thr[:1],
                                bank_trials=nb * tb, **kw))


@pytest.mark.parametrize("bad", ["bank_trials", "static", "thr"])
def test_per_bank_planes_rejected_when_malformed(bad):
    args, kw, static, thr, nb, tb = _gather_case()
    extra = dict(static=static, thr=thr, bank_trials=tb)
    if bad == "bank_trials":
        extra["bank_trials"] = tb + 1
    elif bad == "static":
        extra["static"] = static[:-1]
    else:
        extra["thr"] = thr[:-1]
    with pytest.raises(ValueError):
        S.senseamp_gather_plain(*args, **extra, **kw)


def test_per_bank_planes_against_pallas_folded_plane():
    """The reference's Pallas path folds each bank's threshold into a
    per-trial static plane (shift 0): that reassociates one float add, so
    it agrees only within the reference's own 1e-3 bit tolerance (C-3)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    nb, tb, n, w = 3, 40, 4, 512
    com = RNG.random((nb * tb, n, w), dtype=np.float32)
    rfc = RNG.random((nb * tb, n, w), dtype=np.float32)
    static = RNG.normal(0, .02, (nb, w)).astype(np.float32)
    thr = RNG.normal(0.0, .01, nb).astype(np.float32)
    nz = RNG.normal(0, 1, (nb * tb, w)).astype(np.float32)
    u = RNG.random((nb * tb, w), dtype=np.float32)
    pf, sigma = .05, .012
    tt = [torch.from_numpy(x) for x in (com, rfc, static, thr, nz, u)]
    got = S.senseamp_gather_plain(
        tt[0], range(n), 0, tt[1], range(n), 0, width=w, u_com=.1, u_ref=.1,
        static=tt[2], normals=tt[4], sigma=sigma, u0=tt[5], pf=pf,
        thr=tt[3], bank_trials=tb).numpy()
    coin = np.where(u < np.float32(0.5 * pf), np.float32(0), np.float32(1))
    folded = np.repeat(static, tb, axis=0) - np.repeat(thr, tb)[:, None]
    want = np.asarray(jops.senseamp_resolve_trials(
        jnp.asarray(com), jnp.asarray(rfc), jnp.asarray(folded),
        jnp.asarray(nz), jnp.asarray(np.stack([u, coin])), u_com=.1,
        u_ref=.1, shift=0.0, pf=pf, trial_sigma=sigma))
    assert got.shape == want.shape
    assert np.mean(got != want) <= 1e-3


# ---------------------------------------------------------------------------
# on the card (``cuda`` marker: skipped where there is no CUDA device)
# ---------------------------------------------------------------------------
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_per_bank_planes_kernel_matches_plain_on_card():
    """The Hopper kernel with (N, W) / (N,) planes == its plain twin."""
    dev = _card()
    args, kw, static, thr, nb, tb = _gather_case(nb=5, tb=7, slots=9,
                                                 rb=2048, w=1024)
    mv = lambda x: x.to(dev) if torch.is_tensor(x) else x
    args = tuple(mv(a) for a in args)
    kw = {k: mv(v) for k, v in kw.items()}
    for st, th in ((static, thr), (static, 0.01), (static[0], thr),
                   (static.repeat_interleave(tb, dim=0), thr)):
        before = S.launches
        got = S.senseamp_gather_cuda(*args, static=mv(st), thr=mv(th),
                                     bank_trials=tb, **kw)
        assert S.launches == before + 1
        want = S.senseamp_gather_plain(*args, static=mv(st), thr=mv(th),
                                       bank_trials=tb, **kw)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_matches_loop_device_draws_on_card():
    """Device draws on the card: slice draws == fresh draws, and the fused
    episode == the per-bank loop, bit for bit."""
    dev = _card()
    seqs = [np.random.SeedSequence([s, 0x7A1A1, 1]) for s in (3, 4, 5)]
    fused = _FusedDraws(seqs, 6, "device", dev)
    got = fused.normal((18, 333), torch.float32)
    for b, s in enumerate(seqs):
        one = _TorchDraws(torch_seed(s), dev)
        assert torch.equal(got[6 * b:6 * (b + 1)],
                           one.normal((6, 333), torch.float32))
    ops, bits = _episode_inputs(3, 4, 256)
    arr = TArray(banks=3, seed=7, row_bits=256, error_model="analog",
                 trials=4, track_unshared=False, device="cuda")
    results = []
    for b in range(3):
        isa = arr.isa(b)
        isa.sim.recycle_rows()
        r1 = isa.nary_op("nand", list(torch.from_numpy(
            ops[b].swapaxes(0, 1)).to(dev)))
        isa.sim.recycle_rows()
        results.append((r1.cpu(), isa.op_not(torch.from_numpy(
            bits[b]).to(dev)).cpu()))
    fisa = arr.fused_isa()
    g1 = fisa.nary_op("nand", [torch.from_numpy(np.concatenate(
        [ops[b][:, i] for b in range(3)])).to(dev) for i in range(2)]).cpu()
    g2 = fisa.op_not(torch.from_numpy(np.concatenate(bits)).to(dev)).cpu()
    for b in range(3):
        assert torch.equal(results[b][0], g1[4 * b:4 * (b + 1)]), b
        assert torch.equal(results[b][1], g2[4 * b:4 * (b + 1)]), b
