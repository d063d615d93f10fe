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

Every entry point takes ``device=`` (default ``"cuda"``).  Not ported yet:
the fused multi-bank path (``fused=True`` raises; with ``banks > 1`` the
default runs the per-bank loop, which the reference's fused path matches
bit for bit), the modeled-timing ``stats=`` (it needs ``repro.analysis``)
and the program-level Monte-Carlo.
"""
from __future__ import annotations

import numpy as np
import torch

from . import analog as A
from .analog import CLOSE, FAR, MIDDLE
from .bankarray import BankArray
from . import decoder as DEC
from .device import get_module
from .isa import CapabilityError, PudIsa
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


def _check_unported(fused, stats) -> None:
    if fused:
        raise NotImplementedError(
            "fused=True: the fused multi-bank path is not ported yet (the "
            "default per-bank loop gives the same result)")
    if stats is not None:
        raise NotImplementedError(
            "stats=: modeled multi-bank timing needs repro.analysis, which "
            "is not ported yet")


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
    chips (``dealer``: round-robin by default).
    """
    _check_unported(fused, stats)
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
    _check_unported(fused, stats)
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
# The paper's figures on the Monte-Carlo path
# ---------------------------------------------------------------------------
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
