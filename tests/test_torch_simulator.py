"""Port BankSim (CPU) against the reference numpy BankSim.

Ideal mode must give equal cell state, reads and command logs.  Analog mode
with ``draws="numpy"`` consumes the reference's per-command generators draw
for draw, so results must agree too; the bound is the reference's own
documented comparator-tie tolerance, and the mismatch measured on these
inputs is 0 bits.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.bankarray import BankArray as RefArray
from repro.core.isa import PudIsa as RefIsa
from repro.core.isa import inventory_for
from repro.core.simulator import BankSim as RefSim
from repro_torch.convert import bank_state_from_numpy, numpy_bank_state
from repro_torch.core.bankarray import BankArray
from repro_torch.core.isa import PudIsa
from repro_torch.core.simulator import BankSim

#: the reference's tolerance for resolve-backend parity (float32 ties at
#: the comparator threshold, tests/test_executor.py); measured here: 0
RESOLVE_MISMATCH_TOL = 1e-3


def _pair(**kw):
    ref = RefSim(resolve_backend="numpy", **kw)
    port = BankSim(draws="numpy", device="cpu", **kw)
    return ref, port


def _np(x):
    return x.cpu().numpy()


def _assert_same_state(ref, port, subs=(0, 1, 2)):
    for sub in subs:
        assert np.array_equal(ref._arr(sub), _np(port._arr(sub))), sub
    assert [dataclasses.astuple(e) for e in ref.log.events] == \
        [dataclasses.astuple(e) for e in port.log.events]
    assert ref.log.counts == port.log.counts
    assert ref.log.time_ns == port.log.time_ns
    assert ref.log.energy_pj == port.log.energy_pj


@pytest.mark.parametrize("trials", [None, 3])
def test_ideal_command_sequence_matches(trials):
    """WR / Frac / RowClone / NOT-APA / Boolean-APA in ideal mode: equal
    cell state, row reads and command logs."""
    kw = dict(row_bits=256, seed=5, error_model="ideal", trials=trials)
    ref, port = _pair(**kw)
    rng = np.random.default_rng(1)
    inv = inventory_for(ref.module, ref.seed)
    shape = (256,) if trials is None else (trials, 256)
    for sub in (0, 1, 2):
        for row in rng.choice(512, 6, replace=False):
            bits = rng.integers(0, 2, shape).astype(np.uint8)
            ref.write_row(sub, int(row), bits)
            port.write_row(sub, int(row), bits)
    for sim in (ref, port):
        sim.frac_row(0, 7)
        sim.rowclone(1, 3, 9)
    for n in (1, 2, 4):     # NOT protocol, N:N and N:2N
        rf, rl = inv.choose(max(n // 2, 1), n, 3)
        for sim in (ref, port):
            sim.apa(sim.global_addr(0, rf), sim.global_addr(1, rl),
                    first_act_restored=True)
    for n in (2, 4, 8):     # Boolean protocol on whatever the rows hold
        rf, rl = inv.choose(n, n, 5)
        for sim in (ref, port):
            sim.apa(sim.global_addr(1, rf), sim.global_addr(2, rl))
    for sub, row in ((0, 7), (1, 9), (2, 11)):
        assert np.array_equal(ref.read_row(sub, row),
                              _np(port.read_row(sub, row)))
    rows = [3, 9, 40]
    assert np.array_equal(ref.snapshot_rows(1, rows),
                          _np(port.snapshot_rows(1, rows)))
    _assert_same_state(ref, port)


def _isa_episode(isa, rng, trials):
    """A mix of ISA ops; -> list of result words (numpy)."""
    w = isa.width
    shape = (w,) if trials is None else (trials, w)
    out = []
    for op, n in (("and", 2), ("or", 4), ("nand", 8), ("nor", 2),
                  ("and", 16), ("or", 3)):
        ops = [rng.integers(0, 2, shape).astype(np.uint8) for _ in range(n)]
        out.append(isa.nary_op(op, ops))
    for n_dst in (1, 2, 4):
        out.append(isa.op_not(rng.integers(0, 2, shape).astype(np.uint8),
                              n_dst=n_dst))
    a, b, c = (rng.integers(0, 2, shape).astype(np.uint8) for _ in range(3))
    out.append(isa.op_xor(a, b))
    out.append(isa.op_maj3(a, b, c))
    for sub in (isa.f_sub, isa.l_sub):
        for sl in (isa._f_sl, isa._l_sl):
            out.append(isa.sim.read_shared_word(sub, 0, sl))
    return [np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x)
            for x in out]


@pytest.mark.parametrize("trials", [None, 12])
@pytest.mark.parametrize("track_unshared", [True, False])
def test_analog_numpy_draws_match_reference(trials, track_unshared):
    """Analog mode, draws="numpy": the port resolves every comparator
    exactly as the reference (measured mismatch: 0 bits of ~10^4-10^5)."""
    kw = dict(row_bits=512, seed=3, error_model="analog", trials=trials,
              track_unshared=track_unshared)
    ref, port = _pair(**kw)
    got = _isa_episode(PudIsa(port), np.random.default_rng(7), trials)
    want = _isa_episode(RefIsa(ref), np.random.default_rng(7), trials)
    bad = sum(int(np.sum(g != w)) for g, w in zip(got, want, strict=True))
    total = sum(w.size for w in want)
    assert bad <= RESOLVE_MISMATCH_TOL * total, (bad, total)
    assert bad == 0
    _assert_same_state(ref, port)


def test_fork_reference_state_into_port():
    """Fork one reference episode mid-stream into the port
    (convert.bank_state_from_numpy); both continue identically."""
    kw = dict(row_bits=512, seed=11, error_model="analog", trials=6,
              resolve_backend="numpy")
    ref = RefSim(**kw)
    risa = RefIsa(ref)
    rng = np.random.default_rng(2)
    for op in ("and", "or", "nand"):
        risa.nary_op(op, [rng.integers(0, 2, (6, 256)).astype(np.uint8)
                          for _ in range(4)])
    risa.op_not(rng.integers(0, 2, (6, 256)).astype(np.uint8))
    port = bank_state_from_numpy(numpy_bank_state(ref), "cpu")
    assert port._trial == ref._trial and port.noise_seed == ref.noise_seed
    pisa = PudIsa(port)
    for k, (op, n) in enumerate((("nor", 8), ("and", 2), ("or", 16))):
        ops = [rng.integers(0, 2, (6, 256)).astype(np.uint8)
               for _ in range(n)]
        want = risa.nary_op(op, ops, pair_index=k)
        got = pisa.nary_op(op, ops, pair_index=k)
        assert np.array_equal(want, _np(got)), (op, n)
    bits = rng.integers(0, 2, (6, 256)).astype(np.uint8)
    assert np.array_equal(risa.op_not(bits, n_dst=2, pair_index=4),
                          _np(pisa.op_not(bits, n_dst=2, pair_index=4)))
    for sub in (0, 1):
        assert np.array_equal(ref._arr(sub), _np(port._arr(sub)))


def test_device_draws_follow_the_distribution():
    """draws="device": another stream, the same statistics (ideal inputs
    through the analog comparator)."""
    kw = dict(row_bits=2048, seed=1, error_model="analog", trials=64,
              track_unshared=False)
    ref, port = RefSim(resolve_backend="numpy", **kw), \
        BankSim(device="cpu", **kw)
    rng = np.random.default_rng(0)
    ops = rng.integers(0, 2, (4, 64, 1024)).astype(np.uint8)
    want = np.bitwise_and.reduce(ops)
    acc = [float(np.mean(RefIsa(ref).nary_op("and", ops, pair_index=0)
                         == want)),
           float(np.mean(_np(PudIsa(port).nary_op("and", ops, pair_index=0))
                         == want))]
    assert abs(acc[0] - acc[1]) < 0.01, acc


def test_rejects_unknown_draws_and_error_model():
    with pytest.raises(ValueError):
        BankSim(device="cpu", draws="philox")
    with pytest.raises(ValueError):
        BankSim(device="cpu", error_model="gaussian")


@pytest.mark.parametrize("error_model", ["ideal", "analog"])
def test_isa_word_ops_match_reference(error_model):
    """The ISA's word-level primitives (host words, RowClone, const rows,
    clone-sourced NOT and n-ary ops) against the reference: equal words,
    cell state, command logs and op counters."""
    kw = dict(row_bits=256, seed=4, error_model=error_model, trials=5)
    ref, port = _pair(**kw)
    risa, pisa = RefIsa(ref), PudIsa(port)
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2, (4, 5, 128)).astype(np.uint8)
    n, rf, rl, act = risa.plan_nary("or", 4, pair_index=2)
    got = []
    for isa in (risa, pisa):
        isa.write_word(0, 30, words[0])
        isa.stage_word(1, 31, words[1])
        isa.stage_word(1, 32, words[2])
        isa.fill_const_row(0, 33, 0)
        isa.clone_word(1, 31, 34)
        srcs = [("clone", 31), ("write", words[3]), ("clone", 32),
                ("write", words[0])]
        res_l, res_f = isa.exec_nary("or", rf, rl, act, srcs, ref_row=33)
        nrf, nrl, nact = isa.plan_not(2, pair_index=1)
        isa.clone_word(0, 30, 35)
        not_l, _ = isa.exec_not(nrf, nrl, nact, ("clone", 35))
        out = [isa.read_word(0, 30), isa.read_result_word(1, res_l),
               isa.read_result_word(0, res_f), isa.read_result_word(1, not_l)]
        got.append([np.asarray(_np(x) if hasattr(x, "cpu") else x)
                    for x in out])
    for g, w in zip(got[1], got[0], strict=True):
        assert np.array_equal(g, w)
    port_stats = dataclasses.asdict(pisa.stats)
    ref_stats = dataclasses.asdict(risa.stats)
    assert port_stats == {k: ref_stats[k] for k in port_stats}
    _assert_same_state(ref, port, subs=(0, 1))


def test_bank_array_matches_reference():
    """BankArray (banks=2): per-bank noise seeds, results before and after
    reseed_noise, and the modeled per-bank, makespan and total times equal
    the reference's."""
    kw = dict(banks=2, seed=5, row_bits=256, trials=4)
    ref = RefArray(resolve_backend="numpy", **kw)
    port = BankArray(draws="numpy", device="cpu", **kw)
    assert port.bank_seeds == ref.bank_seeds
    rng = np.random.default_rng(9)

    def episode(ops):
        for (op, n, bank), words in ops:
            want = ref.isa(bank).nary_op(op, words, pair_index=bank)
            got = port.isa(bank).nary_op(op, words, pair_index=bank)
            assert np.array_equal(want, _np(got)), (op, n, bank)

    def ops_for(plan):
        return [((op, n, b), [rng.integers(0, 2, (4, 128)).astype(np.uint8)
                              for _ in range(n)]) for op, n, b in plan]

    episode(ops_for([("and", 4, 0), ("or", 2, 1), ("nand", 8, 1)]))
    ref.reseed_noise(bank=1)
    port.reseed_noise(bank=1)
    episode(ops_for([("nor", 4, 1), ("and", 2, 0)]))
    ref.reseed_noise()
    port.reseed_noise()
    episode(ops_for([("or", 16, 0), ("and", 3, 1)]))
    assert [port.next_noise_seed(b) for b in (0, 1)] == \
        [ref.next_noise_seed(b) for b in (0, 1)]
    assert port.bank_time_ns() == ref.bank_time_ns()
    assert port.makespan_ns() == ref.makespan_ns() > 0
    assert port.total_time_ns() == ref.total_time_ns() > port.makespan_ns()
