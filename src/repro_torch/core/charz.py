"""Characterization harness on the torch bank: the paper's Monte-Carlo.

The port of ``repro.core.charz``'s Monte-Carlo half: trial-batched runs of
the APA command through the ISA on :class:`~repro_torch.core.simulator.
BankSim`, whose per-cell success rates are the paper's Fig. 7 (NOT) and
Fig. 15 (many-input AND/NAND/OR/NOR) — the software twin of its 10,000-trial
DRAM Bender methodology.  Activation pairs are stratified over the 3x3
(R_F region, R_L region) grid exactly as in the reference.

``draws`` picks where the randomness comes from:

* ``"device"`` (default): operand bits and every command's noise are drawn
  by ``torch.Generator``s on the device — the main path on the card;
* ``"numpy"``: the reference's numpy streams, draw for draw, copied to the
  device — results equal the reference's bit for bit.

Program-level characterization (:func:`mc_program_success`) measures the
same statistic one level up: whole compiled programs (XOR from NANDs, MAJ3,
ripple-carry adders) on the noisy bank through ``compiler.run_sim``,
host-staged or resident; :func:`mc_workload_success` and
:func:`workload_fanin_sweep` do so for the workload programs (Bloom probe /
insert, bit-serial dot) beside the independent-op estimate
(:func:`program_success_estimate`).  ``stats=`` receives the modeled
multi-bank timing: the optimistic makespan and the rank-legal one from
:mod:`repro_torch.analysis.schedule`.

The other figure drivers (Figs. 5, 8-12, 16-21 and the abstract's
takeaways) are the calibrated closed form, as in the reference; Obs. 3
(:func:`observation3_perfect_cells`) is a per-cell MC map.

Every Monte-Carlo entry point takes ``device=`` (default ``"cuda"``).  Not
ported yet: the fused multi-bank path (``fused=True`` raises, ROADMAP A-3;
with ``banks > 1`` the default runs the per-bank loop, which the
reference's fused path matches bit for bit).
"""
from __future__ import annotations

import numpy as np
import torch

from functools import lru_cache

from . import analog as A
from . import compiler as CC
from .analog import CLOSE, FAR, MIDDLE
from .bankarray import BankArray
from . import decoder as DEC
from .device import MODULE_ZOO, get_module
from .isa import CapabilityError, PudIsa
from .policy import ResidentPolicy, coerce_resident
from .simulator import DRAWS, BankSim, resolve_device, torch_seed

REGION_NAMES = {CLOSE: "close", MIDDLE: "middle", FAR: "far"}
OPS = ("and", "nand", "or", "nor")
NS = (2, 4, 8, 16)
NOT_DSTS = (1, 2, 4, 8, 16, 32)
TEMPS = (50, 60, 70, 80, 95)

#: stratified activation pairs per batched MC estimate — one per
#: (compute-region, reference-region) combination
MC_PAIR_GROUPS = 9

#: group-dealing strategies for multi-bank MC sweeps
DEALERS = ("round_robin", "occupancy")


def _check_banks(banks, *, batched: bool) -> int:
    """Validate the ``banks`` argument of the mc_* entry points."""
    if isinstance(banks, bool) or not isinstance(banks, (int, np.integer)):
        raise TypeError(
            f"banks must be an int, got {type(banks).__name__}")
    banks = int(banks)
    if banks > 1 and not batched:
        raise ValueError(
            "banks > 1 requires batched=True (the per-trial reference "
            "path is single-bank)")
    return banks


def _check_fused(fused) -> None:
    if fused:
        raise NotImplementedError(
            "fused=True: the fused multi-bank path (core/fused.py) is not "
            "ported yet, ROADMAP A-3 (the default per-bank loop gives the "
            "same result)")


def _fill_stats(stats: dict | None, arr: BankArray, groups: int,
                tg: int) -> None:
    """Record modeled concurrent-bank timing into a caller-passed dict:
    the optimistic independent-bank ``makespan_ns`` and the rank-legal
    ``legal_makespan_ns`` (the :mod:`repro_torch.analysis.schedule`
    event-driven schedule of the same logs), with the legality cost split
    into cross-bank arbitration (``rank_stall_ns``) and refresh
    (``refresh_stall_ns``) stalls."""
    if stats is None:
        return
    from .. import analysis         # analysis sits above core
    tl = analysis.schedule_bank_array(arr)
    stats.update({
        "banks": arr.banks, "groups": groups, "trials_per_group": tg,
        "bank_time_ns": arr.bank_time_ns(),
        "makespan_ns": arr.makespan_ns(),
        "total_time_ns": arr.total_time_ns(),
        "legal_makespan_ns": tl.legal_makespan_ns,
        "rank_stall_ns": tl.rank_stall_ns,
        "refresh_stall_ns": tl.refresh_stall_ns,
        "refreshes": tl.refreshes,
    })


class _Operands:
    """Operand-bit source of one MC run: the reference's numpy generator
    (``seed + 1``) copied to the device, or a ``torch.Generator`` on it."""

    def __init__(self, seed: int, draws: str, device: torch.device):
        if draws not in DRAWS:
            raise ValueError(f"draws must be one of {DRAWS}, got {draws!r}")
        self.device = device
        if draws == "numpy":
            self.rng = np.random.default_rng(seed + 1)
            self.gen = None
        else:
            self.rng = None
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(torch_seed(
                np.random.SeedSequence([seed + 1, 0x0BE7A])))

    def _rand(self, shape) -> torch.Tensor:
        return torch.randint(0, 2, shape, generator=self.gen,
                             device=self.device, dtype=torch.uint8)

    def bits(self, shape) -> torch.Tensor:
        """Uniform 0/1 uint8 bits in bulk (the batched paths)."""
        if self.gen is not None:
            return self._rand(shape)
        n = int(np.prod(shape))
        raw = np.frombuffer(self.rng.bytes((n + 7) // 8), dtype=np.uint8)
        return torch.from_numpy(np.unpackbits(raw)[:n].reshape(shape)) \
            .to(self.device)

    def word(self, w: int) -> torch.Tensor:
        """One word of 0/1 bits (the per-trial reference paths)."""
        if self.gen is not None:
            return self._rand((w,))
        return torch.from_numpy(
            self.rng.integers(0, 2, w).astype(np.uint8)).to(self.device)


def _want_nary(op: str, ops: torch.Tensor, dim: int = 0) -> torch.Tensor:
    base, is_ref = A._base_op(op)
    want = ops.amin(dim=dim) if base == "and" else ops.amax(dim=dim)
    return 1 - want if is_ref else want


def _hits(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got == want).sum())


# ---------------------------------------------------------------------------
# Monte-Carlo measurement through the full simulator stack
# ---------------------------------------------------------------------------
def _stratified_pairs(isa: PudIsa, n_rf: int, n_rl: int,
                      groups: int, *, seed: int) -> list[tuple[int, int]]:
    """``groups`` (R_F, R_L) address pairs cycling the 3x3 region grid
    (the paper's uniform row sweep, one pinned pair per batch)."""
    ps = isa.inv.pairs(n_rf, n_rl)
    if len(ps) == 0:
        raise CapabilityError(
            f"module {isa.sim.module.name} has no {n_rf}:{n_rl} pairs")
    geom = isa.sim.geom
    reg_f = geom.distance_regions(ps[:, 0], toward_upper=isa.f_sub > isa.l_sub)
    reg_l = geom.distance_regions(ps[:, 1], toward_upper=isa.l_sub > isa.f_sub)
    buckets = {(rf, rl): np.nonzero((reg_f == rf) & (reg_l == rl))[0]
               for rf in (0, 1, 2) for rl in (0, 1, 2)}
    combos = [(rf, rl) for rf in (0, 1, 2) for rl in (0, 1, 2)]
    module, mseed = isa.sim.module, isa.sim.seed
    out = []
    for g in range(groups):
        idxs = buckets[combos[g % len(combos)]]
        if len(idxs) == 0:           # region combo unreachable on this module
            idxs = np.arange(len(ps))
        # sequential-activation modules miss on a fraction of listed pairs;
        # rescramble within the bucket until the decoder actually fires
        for salt in range(16):
            k = DEC._mix64((g + groups * salt) * 0x9E3779B97F4A7C15
                           + seed) % len(idxs)
            rf, rl = (int(x) for x in ps[idxs[k]])
            if DEC.activation_pattern(module, rf, rl, seed=mseed).n_rf:
                out.append((rf, rl))
                break
    if not out:
        raise CapabilityError(
            f"no activating {n_rf}:{n_rl} pairs found on {module.name}")
    return out


def _deal_groups(arr: BankArray, n_groups: int,
                 dealer: str = "round_robin",
                 weights=None) -> list[int]:
    """Bank index for each of ``n_groups`` MC group slots: ``round_robin``
    (group g on bank ``g % banks``) or ``occupancy`` (least projected
    command time first)."""
    if dealer not in DEALERS:
        raise ValueError(f"unknown dealer {dealer!r} (want one of "
                         f"{DEALERS})")
    if dealer == "round_robin":
        return [g % arr.banks for g in range(n_groups)]
    load = [float(t) for t in arr.bank_time_ns()]
    if weights is None:
        w = [1.0] * n_groups
    else:
        w = [float(x) for x in weights]
        if len(w) != n_groups:
            raise ValueError(f"want {n_groups} weights, got {len(w)}")
    out = []
    for g in range(n_groups):
        b = min(range(arr.banks), key=lambda i: (load[i], i))
        load[b] += w[g]
        out.append(b)
    return out


def _bank_pair_schedule(arr: BankArray, groups: int, pairs_of, *,
                        dealer: str = "round_robin", weights=None):
    """Deal MC pair groups across the array's banks; each bank consumes
    its own stratified pair list in order.  Yields ``(isa, pair)``."""
    its = {}
    for b in _deal_groups(arr, groups, dealer, weights):
        if b not in its:
            its[b] = iter(pairs_of(arr.isa(b)))
        pair = next(its[b], None)
        if pair is not None:        # a bank may drop decoder-miss groups
            yield arr.isa(b), pair


def mc_boolean_success(op: str, n: int, *, trials: int = 200,
                       row_bits: int = 2048, seed: int = 0,
                       module: str | None = None, temp_c: float = 50.0,
                       batched: bool = True, banks: int = 1,
                       groups: int = MC_PAIR_GROUPS,
                       fused: bool | None = None,
                       dealer: str = "round_robin",
                       stats: dict | None = None, draws: str = "device",
                       device: str | torch.device = "cuda") -> float:
    """Cell-averaged MC success of an n-input op on the noisy simulator.

    ``batched=True`` (default) runs ``ceil(trials/groups)`` trials per
    stratified activation pair in one episode each; ``batched=False`` is
    the per-trial reference (one episode per trial, scrambled pair walk).
    ``banks`` deals the groups over a :class:`BankArray` of independent
    chips (``dealer``: round-robin by default).  ``stats``, if a dict,
    receives the modeled concurrent-bank timing (:func:`_fill_stats`).
    """
    _check_fused(fused)
    banks = _check_banks(banks, batched=batched)
    dev = resolve_device(device)
    draw = _Operands(seed, draws, dev)
    if not batched:
        sim = BankSim(module or get_module(), row_bits=row_bits, seed=seed,
                      temp_c=temp_c, error_model="analog", draws=draws,
                      device=dev)
        isa = PudIsa(sim)
        ok = 0
        tot = 0
        for _t in range(trials):
            ops = torch.stack([draw.word(isa.width) for _ in range(n)])
            got = isa.nary_op(op, list(ops))
            ok += _hits(got, _want_nary(op, ops))
            tot += isa.width
        return ok / tot
    tg = max(1, -(-trials // groups))
    arr = BankArray(module or get_module(), banks=banks, row_bits=row_bits,
                    seed=seed, temp_c=temp_c, error_model="analog",
                    trials=tg, track_unshared=False, draws=draws, device=dev)
    ok = 0
    tot = 0
    for isa, pair in _bank_pair_schedule(
            arr, groups, lambda isa: _stratified_pairs(isa, n, n, groups,
                                                       seed=seed),
            dealer=dealer):
        isa.sim.recycle_rows()      # bound the hot working set to one op
        # trial-major draw: operand staging reads it contiguously
        ops = draw.bits((tg, n, isa.width))
        got = isa.nary_op(op, ops.swapaxes(0, 1), pair=pair)
        ok += _hits(got, _want_nary(op, ops, dim=1))
        tot += got.numel()
    _fill_stats(stats, arr, groups, tg)
    return ok / tot


def mc_not_success(n_dst: int = 1, *, trials: int = 200, row_bits: int = 2048,
                   seed: int = 0, module: str | None = None,
                   batched: bool = True, banks: int = 1,
                   groups: int = MC_PAIR_GROUPS,
                   fused: bool | None = None,
                   dealer: str = "round_robin",
                   stats: dict | None = None, draws: str = "device",
                   device: str | torch.device = "cuda") -> float:
    """NOT-protocol MC success; knobs as :func:`mc_boolean_success`."""
    _check_fused(fused)
    banks = _check_banks(banks, batched=batched)
    dev = resolve_device(device)
    draw = _Operands(seed, draws, dev)
    if not batched:
        sim = BankSim(module or get_module(), row_bits=row_bits, seed=seed,
                      error_model="analog", draws=draws, device=dev)
        isa = PudIsa(sim)
        ok = 0
        tot = 0
        for _t in range(trials):
            bits = draw.word(isa.width)
            got = isa.op_not(bits, n_dst=n_dst)
            ok += _hits(got, 1 - bits)
            tot += isa.width
        return ok / tot
    tg = max(1, -(-trials // groups))
    arr = BankArray(module or get_module(), banks=banks, row_bits=row_bits,
                    seed=seed, error_model="analog", trials=tg,
                    track_unshared=False, draws=draws, device=dev)
    ok = 0
    tot = 0
    for isa, pair in _bank_pair_schedule(
            arr, groups,
            lambda isa: _stratified_pairs(isa, isa.not_activation(n_dst),
                                          n_dst, groups, seed=seed),
            dealer=dealer):
        isa.sim.recycle_rows()      # bound the hot working set to one op
        bits = draw.bits((tg, isa.width))
        got = isa.op_not(bits, n_dst=n_dst, pair=pair)
        ok += _hits(got, 1 - bits)
        tot += got.numel()
    _fill_stats(stats, arr, groups, tg)
    return ok / tot


def measure_cell_map(op: str, n: int, *, trials: int = 300,
                     row_bits: int = 2048, seed: int = 0,
                     batched: bool = True, draws: str = "device",
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Per-cell success map (the paper's per-cell protocol) at one fixed
    activation pair -> (w,) float64 tensor on the device."""
    dev = resolve_device(device)
    draw = _Operands(seed, draws, dev)
    tg = min(trials, 64) if batched else None
    sim = BankSim(get_module(), row_bits=row_bits, seed=seed,
                  error_model="analog", trials=tg,
                  track_unshared=not batched, draws=draws, device=dev)
    isa = PudIsa(sim)
    hits = torch.zeros(isa.width, dtype=torch.int64, device=dev)
    if not batched:
        for _t in range(trials):
            ops = torch.stack([draw.word(isa.width) for _ in range(n)])
            got = isa.nary_op(op, list(ops), pair_index=0)
            hits += got == _want_nary(op, ops)
        return hits.to(torch.float64) / trials
    done = 0
    while done < trials:
        sim.recycle_rows()
        ops = draw.bits((tg, n, isa.width))
        got = isa.nary_op(op, ops.swapaxes(0, 1), pair_index=0)
        take = min(tg, trials - done)
        hits += (got == _want_nary(op, ops, dim=1))[:take].sum(dim=0)
        done += take
    return hits.to(torch.float64) / trials


def measure_cell_map_not(*, trials: int = 200, row_bits: int = 2048,
                         seed: int = 0, batched: bool = True,
                         draws: str = "device",
                         device: str | torch.device = "cuda") -> torch.Tensor:
    """Per-cell NOT success map (Obs. 3: some cells are 100%-reliable)."""
    dev = resolve_device(device)
    draw = _Operands(seed, draws, dev)
    tg = min(trials, 64) if batched else None
    sim = BankSim(get_module(), row_bits=row_bits, seed=seed,
                  error_model="analog", trials=tg,
                  track_unshared=not batched, draws=draws, device=dev)
    isa = PudIsa(sim)
    hits = torch.zeros(isa.width, dtype=torch.int64, device=dev)
    if not batched:
        for _t in range(trials):
            bits = draw.word(isa.width)
            got = isa.op_not(bits, n_dst=1, pair_index=0)
            hits += got == 1 - bits
        return hits.to(torch.float64) / trials
    done = 0
    while done < trials:
        sim.recycle_rows()
        bits = draw.bits((tg, isa.width))
        got = isa.op_not(bits, n_dst=1, pair_index=0)
        take = min(tg, trials - done)
        hits += (got == 1 - bits)[:take].sum(dim=0)
        done += take
    return hits.to(torch.float64) / trials


# ---------------------------------------------------------------------------
# Program-level Monte-Carlo (composed operations through the executor)
# ---------------------------------------------------------------------------
#: headline compiled programs for program-level characterization
PROGRAMS = ("xor", "maj3", "add4")

#: workload-level compiled programs (bloom dedup + bit-serial dot
#: product); a trailing integer parameterizes them (``bloom_probe8`` =
#: 8-hash probe, ``dot_bitserial8`` = K=8 dot)
WORKLOAD_PROGRAMS = ("bloom_probe", "bloom_insert", "dot_bitserial")


@lru_cache(maxsize=64)
def get_program(name: str) -> CC.Program:
    """Compile one of the named characterization/workload programs."""
    if name == "xor":
        return CC.compile_expr(CC.Xor(CC.Var("a"), CC.Var("b")))
    if name == "maj3":
        return CC.compile_expr(CC.Maj(CC.Var("a"), CC.Var("b"), CC.Var("c")))
    if name.startswith("bloom_probe"):
        return CC.compile_expr(
            CC.bloom_probe_exprs(int(name[11:] or 4)))
    if name.startswith("bloom_insert"):
        return CC.compile_expr(
            CC.bloom_insert_exprs(int(name[12:] or 4)))
    if name.startswith("dot_bitserial"):
        return CC.compile_expr(CC.dot_exprs(int(name[13:] or 4)))
    if name.startswith("add"):
        return CC.compile_expr(CC.adder_exprs(int(name[3:])))
    raise ValueError(f"unknown program {name!r} (want one of "
                     f"{PROGRAMS + WORKLOAD_PROGRAMS})")


def program_success_estimate(name: "str | CC.Program",
                             module: str | None = None, **kw) -> float:
    """Independent-op estimate: product of per-instruction closed-form
    success rates on the given module.  A lower bound in spirit — real
    programs do better because an op error only corrupts an output bit if
    it happens to propagate to it."""
    m = get_module(module) if module else get_module()
    kw = {"mfr": m.manufacturer.value, "density_gb": m.density_gb,
          "die_rev": m.die_rev, "speed_mts": m.speed_mts} | kw
    p = 1.0
    prog = get_program(name) if isinstance(name, str) else name
    for i in prog.instrs:
        if i.op == "not":
            p *= A.not_success(1, **kw)
        elif i.op in ("and", "or", "nand", "nor"):
            p *= A.boolean_success_avg(i.op, max(len(i.srcs), 2), **kw)
    return p


def mc_program_success(program: str | CC.Program, *, trials: int = 200,
                       row_bits: int = 2048, seed: int = 0,
                       module: str | None = None, temp_c: float = 50.0,
                       batched: bool = True,
                       resident: ResidentPolicy | bool | str | None = None,
                       banks: int = 1, groups: int = MC_PAIR_GROUPS,
                       fused: bool | None = None,
                       dealer: str = "round_robin",
                       stats: dict | None = None, draws: str = "device",
                       device: str | torch.device = "cuda") -> float:
    """Bit-averaged MC success of a whole compiled program on the noisy
    bank: every output bit of every trial is compared against
    ``compiler.run_ideal`` on the same random inputs.

    ``batched=True`` (default) splits the trials over ``groups``
    trial-batched ``compiler.run_sim`` episodes; the ISA's scrambled pair
    walk advances across groups.  ``batched=False`` is the per-trial
    reference (one program execution per trial on a scalar sim).
    ``resident`` (a :class:`~repro_torch.core.policy.ResidentPolicy`)
    routes execution through the resident-register executor; under
    ``SCHEDULED`` the search runs once (memoized) and later groups replan
    with the frozen decisions.  ``banks`` deals the groups over a
    :class:`BankArray` (``dealer``); sibling banks replay bank 0's
    scheduler decisions.  ``stats``, if a dict, receives the modeled
    concurrent-bank timing.
    """
    _check_fused(fused)
    prog = get_program(program) if isinstance(program, str) else program
    pol = coerce_resident(resident, where="charz.mc_program_success")
    names = sorted({i.name for i in prog.instrs if i.op == "input"})
    dev = resolve_device(device)
    draw = _Operands(seed, draws, dev)
    ok = 0
    tot = 0
    if pol.is_resident and not batched:
        raise ValueError("resident execution requires batched=True")
    banks = _check_banks(banks, batched=batched)

    def score(got: dict, ins: dict, width: int) -> None:
        nonlocal ok, tot
        want = CC.run_ideal(prog, ins, width=width)
        ok += sum(_hits(got[k], want[k]) for k in prog.outputs)
        tot += sum(got[k].numel() for k in prog.outputs)

    if batched:
        groups = max(1, min(groups, trials))
        tg = max(1, -(-trials // groups))
        arr = BankArray(module or get_module(), banks=banks,
                        row_bits=row_bits, seed=seed, temp_c=temp_c,
                        error_model="analog", trials=tg,
                        track_unshared=False, draws=draws, device=dev)
        decisions = None
        for bank_g in _deal_groups(arr, groups, dealer):
            isa = arr.isa(bank_g)
            plan = None
            if pol.is_resident:
                isa.sim.recycle_rows()  # resident runs re-stage all state
                if pol is ResidentPolicy.SCHEDULED:
                    if isa.bank == 0:
                        # the search result is cached: group 1 pays it,
                        # later groups replan with frozen decisions
                        plan = CC.schedule_resident(prog, isa,
                                                    policy="scheduled")
                    else:
                        # sibling banks replay bank 0's decisions
                        if decisions is None:
                            decisions = CC.shared_schedule_decisions(
                                prog, arr.isa(0))
                        plan = CC.schedule_resident(prog, isa,
                                                    policy="scheduled",
                                                    _fixed=decisions)
            ins = {n: draw.bits((tg, isa.width)) for n in names}
            got = CC.run_sim(prog, ins, isa, trials=tg, resident=pol,
                             plan=plan)
            score(got, ins, isa.width)
        _fill_stats(stats, arr, groups, tg)
        return ok / tot
    sim = BankSim(module or get_module(), row_bits=row_bits, seed=seed,
                  temp_c=temp_c, error_model="analog", draws=draws,
                  device=dev)
    isa = PudIsa(sim)
    for _t in range(trials):
        ins = {n: draw.bits((isa.width,)) for n in names}
        score(CC.run_sim(prog, ins, isa), ins, isa.width)
    return ok / tot


# ---------------------------------------------------------------------------
# Workload-level Monte-Carlo (compiled application programs)
# ---------------------------------------------------------------------------
def mc_workload_success(workload: str, *, fanin: int | None = None,
                        **kw) -> float:
    """Program-level MC success of one named workload program
    (``WORKLOAD_PROGRAMS``): the per-output-bit success of the compiled
    bloom probe/insert or bit-serial dot program on the noisy bank.
    ``fanin`` parameterizes the program (``bloom_probe`` fan-in =
    n_hashes, ``dot_bitserial`` = K bit positions); remaining kwargs are
    :func:`mc_program_success`'s (trials, banks, resident, draws,
    device, ...)."""
    if workload not in WORKLOAD_PROGRAMS:
        raise ValueError(f"unknown workload {workload!r} "
                         f"(want one of {WORKLOAD_PROGRAMS})")
    name = workload if fanin is None else f"{workload}{fanin}"
    return mc_program_success(get_program(name), **kw)


def workload_fanin_sweep(workloads=("bloom_probe", "bloom_insert"),
                         fanins=(2, 4, 8, 16), **kw) -> dict:
    """Success vs fan-in for the bloom probe/insert programs — the paper's
    many-input AND/OR measured at *workload* fan-ins, with the closed-form
    independent-op estimate next to each MC number (the
    ``reliability.plan`` composition contract).  ``kw`` goes to
    :func:`mc_program_success` (``device=`` defaults to ``"cuda"``).

    Returns ``{f"{workload}{fanin}": {"mc_success", "estimate"}}``.
    """
    est_kw = {k: kw[k] for k in ("temp_c",) if k in kw}
    module = kw.get("module")
    out: dict[str, dict] = {}
    for wl in workloads:
        for n in fanins:
            name = f"{wl}{n}"
            out[name] = {
                "mc_success": float(mc_program_success(
                    get_program(name), **kw)),
                "estimate": float(program_success_estimate(
                    name, module=module, **est_kw)),
            }
    return out


# ---------------------------------------------------------------------------
# One-call closed-form samplers (torch generators on the device)
# ---------------------------------------------------------------------------
def model_boolean_success(op: str, n: int, *, trials: int = 10_000,
                          width: int = 1024, seed: int = 0,
                          device: str | torch.device = "cuda",
                          **kw) -> float:
    """MC over the closed-form model in one call (no command-level
    simulation) — for paper-scale (10k+) trial counts."""
    from . import analog_torch as AT
    return AT.sample_boolean_success(op, n, trials=trials, width=width,
                                     seed=seed, device=device, **kw)


def model_not_success(n_dst: int = 1, *, trials: int = 10_000,
                      width: int = 1024, seed: int = 0,
                      device: str | torch.device = "cuda", **kw) -> float:
    from . import analog_torch as AT
    return AT.sample_not_success(n_dst, trials=trials, width=width,
                                 seed=seed, device=device, **kw)


# ---------------------------------------------------------------------------
# One function per paper figure (closed form; Figs. 7 / 15 add the MC)
# ---------------------------------------------------------------------------
def fig5_activation_coverage(module: str | None = None, seed: int = 0) -> dict:
    """Coverage of each N_RF:N_RL activation type (Fig. 5)."""
    m = get_module(module) if module else get_module()
    got = DEC.coverage(m, seed=seed)
    paper = {f"{a}:{b}": c for (a, b), c in DEC.FIG5_COVERAGE}
    return {"model": got, "paper": paper}


def fig7_not_vs_dst_rows(mc: bool = False, trials: int = 100,
                         batched: bool = True, *, draws: str = "device",
                         device: str | torch.device = "cuda") -> dict:
    """NOT success vs destination rows (Fig. 7): closed form, plus the MC
    estimate when ``mc``."""
    out = {}
    for d in NOT_DSTS:
        pattern = "NN" if d == 1 else "N2N"
        row = {"closed_form": A.not_success(d, pattern=pattern)}
        if mc:
            row["monte_carlo"] = mc_not_success(
                d, trials=trials, batched=batched, draws=draws,
                device=device)
        out[d] = row
    out["paper"] = {1: 0.9837, 32: 0.0795}
    return out


def fig15_ops_vs_inputs(mc: bool = False, trials: int = 60,
                        batched: bool = True, *, draws: str = "device",
                        device: str | torch.device = "cuda") -> dict:
    """AND/NAND/OR/NOR success vs input count (Fig. 15)."""
    out = {}
    for op in OPS:
        row = {}
        for n in NS:
            cell = {"closed_form": A.boolean_success_avg(op, n)}
            if mc:
                cell["monte_carlo"] = mc_boolean_success(
                    op, n, trials=trials, batched=batched, draws=draws,
                    device=device)
            row[n] = cell
        out[op] = row
    out["paper_16"] = {"and": 0.9494, "nand": 0.9494, "or": 0.9585,
                       "nor": 0.9587}
    return out


def fig8_not_activation_patterns() -> dict:
    """NOT success per N_RF:N_RL type (Obs. 5)."""
    out = {}
    for n in (1, 2, 4, 8, 16):
        out[f"{n}:{n}"] = A.not_success(n, pattern="NN")
        out[f"{n}:{2*n}"] = A.not_success(2 * n, pattern="N2N")
    adv = float(np.mean([A.not_success(d, pattern="N2N")
                         - A.not_success(d, pattern="NN")
                         for d in (2, 4, 8, 16)]))
    out["n2n_advantage"] = adv
    out["paper_n2n_advantage"] = 0.0941
    return out


def fig9_not_distance_heatmap() -> dict:
    """NOT success by (src region, dst region) (Obs. 6)."""
    grid = {}
    for rs in (CLOSE, MIDDLE, FAR):
        for rd in (CLOSE, MIDDLE, FAR):
            vals = [A.not_success(1, pattern="NN", src_region=rs,
                                  dst_region=rd)]
            vals += [A.not_success(d, pattern="N2N", src_region=rs,
                                   dst_region=rd) for d in (2, 4, 8, 16, 32)]
            grid[f"{REGION_NAMES[rs]}-{REGION_NAMES[rd]}"] = \
                float(np.mean(vals))
    grid["paper_middle-far"] = 0.8502
    grid["paper_far-close"] = 0.4416
    return grid


def fig10_not_temperature() -> dict:
    """NOT success vs temperature (Fig. 10)."""
    out = {}
    for d in NOT_DSTS:
        pattern = "NN" if d == 1 else "N2N"
        out[d] = {t: A.not_success(d, pattern=pattern, temp_c=t)
                  for t in TEMPS}
    return out


def fig11_not_speed() -> dict:
    """NOT success vs speed grade (Fig. 11)."""
    out = {}
    for d in (1, 2, 4, 8):
        out[d] = {s: A.not_success(d, pattern="NN" if d == 1 else "N2N",
                                   speed_mts=s)
                  for s in (2133, 2400, 2666)}
    return out


def fig12_not_die_revision() -> dict:
    """NOT×1 success per NOT-capable module of the zoo (Fig. 12)."""
    out = {}
    for name, m in MODULE_ZOO.items():
        if not m.supports_not:
            continue
        out[name] = A.not_success(
            1, pattern="NN", mfr=m.manufacturer.value,
            density_gb=m.density_gb, die_rev=m.die_rev,
            speed_mts=m.speed_mts)
    return out


def fig16_k_dependence() -> dict:
    """Success vs the number k of logic-1 operands (Fig. 16)."""
    out = {}
    for op, n in (("and", 4), ("and", 16), ("or", 4), ("or", 16)):
        ks = np.arange(n + 1)
        out[f"{op}{n}"] = A.boolean_success(op, n, ks).tolist()
    return out


def fig17_ops_distance_heatmap() -> dict:
    """Success by (compute region, reference region) (Fig. 17)."""
    out = {}
    for op in OPS:
        g = np.mean([A.boolean_success_avg_grid(op, n) for n in NS], axis=0)
        grid = {f"{REGION_NAMES[rc]}-{REGION_NAMES[rr]}": float(g[rc, rr])
                for rc in (CLOSE, MIDDLE, FAR) for rr in (CLOSE, MIDDLE, FAR)}
        vals = list(grid.values())
        grid["spread"] = max(vals) - min(vals)
        out[op] = grid
    out["paper_spread"] = {"and": 0.2336, "nand": 0.2370, "or": 0.1042,
                           "nor": 0.1050}
    return out


def fig18_data_pattern() -> dict:
    """All-0/1 vs random operand patterns (Fig. 18)."""
    out = {}
    for op in OPS:
        out[op] = {
            n: {"all01": A.boolean_success_avg(op, n, random_pattern=False),
                "random": A.boolean_success_avg(op, n, random_pattern=True)}
            for n in NS}
        out[op]["avg_delta"] = float(np.mean(
            [out[op][n]["all01"] - out[op][n]["random"] for n in NS]))
    out["paper_avg_delta"] = {"and": 0.0143, "nand": 0.0139, "or": 0.0198,
                              "nor": 0.0197}
    return out


def fig19_ops_temperature() -> dict:
    """Boolean-op success vs temperature (Fig. 19)."""
    out = {}
    for op in OPS:
        out[op] = {n: {t: A.boolean_success_avg(op, n, temp_c=t)
                       for t in TEMPS} for n in NS}
        out[op]["max_delta"] = max(
            abs(out[op][n][95] - out[op][n][50]) for n in NS)
    out["paper_max_delta"] = {"and": 0.0166, "nand": 0.0165, "or": 0.0163,
                              "nor": 0.0164}
    return out


def fig20_ops_speed() -> dict:
    """Boolean-op success vs speed grade (Fig. 20)."""
    out = {}
    for op in OPS:
        out[op] = {n: {s: A.boolean_success_avg(op, n, speed_mts=s)
                       for s in (2133, 2400, 2666)} for n in NS}
    out["paper_nand4_2133_2400"] = 0.2989
    return out


def fig21_ops_die_revision() -> dict:
    """Boolean-op success per density / die revision (Fig. 21)."""
    out = {}
    for dens, rev in ((4, "A"), (4, "M"), (8, "A"), (8, "M")):
        out[f"hynix_{dens}gb_{rev}"] = {
            op: {n: A.boolean_success_avg(op, n, density_gb=dens, die_rev=rev)
                 for n in NS} for op in OPS}
    return out


def observation3_perfect_cells(trials: int = 300, *, draws: str = "device",
                               device: str | torch.device = "cuda") -> dict:
    """Obs. 3: existence of 100%-success cells (MC, per-cell map of the
    4-input AND)."""
    m = measure_cell_map("and", 4, trials=trials, draws=draws,
                         device=device)
    return {
        "n_cells": m.numel(),
        "perfect_cells": int((m >= 1.0).sum()),
        "zero_cells": int((m <= 0.0).sum()),
        "mean": float(m.mean()),
    }


def takeaway_tables() -> dict:
    """The four headline numbers of the abstract."""
    return {
        "not_1dst": {"model": A.not_success(1), "paper": 0.9837},
        "nand16": {"model": A.boolean_success_avg("nand", 16),
                   "paper": 0.9494},
        "nor16": {"model": A.boolean_success_avg("nor", 16), "paper": 0.9587},
        "and16": {"model": A.boolean_success_avg("and", 16), "paper": 0.9494},
        "or16": {"model": A.boolean_success_avg("or", 16), "paper": 0.9585},
    }
