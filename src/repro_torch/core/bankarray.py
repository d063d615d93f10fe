"""BankArray: N independent per-bank chips behind one device-addressed API.

The port of ``repro.core.bankarray``'s device addressing.  Each bank is its
own chip identity (decoder map + static sense-amp offsets) with its own
noise streams, derived from the array seed exactly as in the reference:
bank 0 uses ``seed`` itself (so ``BankArray(banks=1)`` is a plain
``BankSim(seed=seed)``), banks 1..N-1 take seeds from the spawn children
of ``SeedSequence([seed, 0xBA2C5])``.  The modeled array time is the
makespan over the per-bank command logs.

Resident plans cannot move between banks (row assignments and activation
patterns depend on each bank's seed), but the schedule decisions are
geometry-determined: the scheduler search runs once on bank 0 and every
other bank replays the frozen decisions (:meth:`schedule_decisions`,
:meth:`sessions`).  The cross-bank reduction tree (:meth:`tree_reduce_add`,
:meth:`popcount`) combines per-bank partial sums pairwise in
``ceil(log2 N)`` rounds of in-bank ripple-carry adds; each merge
round-trips the source bank's planes through the host (DDR4 has no
bank-to-bank path), charged to the destination bank's log.

:meth:`fused_isa` stacks banks onto the trial axis: one
:class:`~repro_torch.core.fused.FusedPudIsa` episode runs the same command
stream on several banks at once, bit-identical per bank to the per-bank
loop (:mod:`repro_torch.core.fused`); its command log accrues to each of
its banks.

:meth:`makespan_ns` is optimistic (every bank issues from t=0 with a
private command bus); :meth:`legal_makespan_ns` is the rank-legal
counterpart from :mod:`repro_torch.analysis.schedule`.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import trace
from . import compiler as CC
from .device import get_module
from .isa import PudIsa
from .policy import ResidentPolicy, coerce_resident
from .simulator import BankSim, resolve_device


@lru_cache(maxsize=16)
def _adder_program(k: int) -> CC.Program:
    return CC.compile_expr(CC.adder_exprs(k))


@lru_cache(maxsize=16)
def _popcount_program(n: int) -> CC.Program:
    return CC.compile_expr(CC.popcount_exprs(n))


class BankArray:
    """N independent per-bank ``BankSim``s addressed as one device.

    Constructor arguments mirror ``BankSim`` (module, row_bits, seed,
    temp_c, error_model, trials, draws, device, ...); ``banks`` adds the
    device axis.  Sims are built lazily per ``(bank, trials, overrides)``
    by :meth:`isa`."""

    def __init__(self, module=None, *, banks: int = 1, seed: int = 0,
                 row_bits: int | None = None, temp_c: float = 50.0,
                 error_model: str = "analog", trials: int | None = None,
                 track_unshared: bool = True, **sim_kwargs):
        if banks < 1:
            raise ValueError(f"banks must be >= 1, got {banks}")
        self.module = (get_module(module) if isinstance(module, str)
                       else module or get_module())
        #: where every bank's cells (and the reduction tree's planes) live
        self.device = resolve_device(sim_kwargs.get("device", "cuda"))
        self.banks = banks
        self.seed = seed
        self.trials = trials
        self._sim_kwargs = dict(row_bits=row_bits, temp_c=temp_c,
                                error_model=error_model,
                                track_unshared=track_unshared, **sim_kwargs)
        ident = np.random.SeedSequence([seed, 0xBA2C5])
        self.bank_seeds: list[int] = [seed] + [
            int(c.generate_state(1, np.uint64)[0])
            for c in ident.spawn(banks - 1)]
        #: per-bank noise-stream derivation (chip identity stays fixed)
        self._noise_seqs = [np.random.SeedSequence(s)
                            for s in self.bank_seeds]
        self._isas: dict[tuple, PudIsa] = {}
        #: fused (bank-stacked) ISAs, keyed (n_banks, trials, overrides):
        #: one fused sim's log accounts to all of its banks
        self._fused: dict[tuple, "FusedPudIsa"] = {}

    # ------------- device addressing -------------
    def __len__(self) -> int:
        return self.banks

    def isa(self, bank: int = 0, trials: int | None = ...,
            **overrides) -> PudIsa:
        """The ISA of one bank at one trial-batch size (built on first use,
        cached per ``(bank, trials, overrides)``); ``overrides`` replace
        individual ``BankSim`` kwargs for this sim only."""
        if not 0 <= bank < self.banks:
            raise IndexError(f"bank {bank} out of range 0..{self.banks - 1}")
        t = self.trials if trials is ... else trials
        key = (bank, t, tuple(sorted(overrides.items())))
        if key not in self._isas:
            with trace.span("pud.chip"):
                sim = BankSim(self.module, seed=self.bank_seeds[bank],
                              bank=bank, trials=t,
                              **{**self._sim_kwargs, **overrides})
                self._isas[key] = PudIsa(sim, bank=bank)
        return self._isas[key]

    def fused_isa(self, n_banks: int | None = None,
                  trials: int | None = ..., **overrides):
        """One bank-stacked :class:`~repro_torch.core.fused.FusedPudIsa`
        over the first ``n_banks`` banks (default: all) at ``trials`` per
        bank: one ``(n_banks * trials, slots, bits)`` episode, bit-identical
        per bank to the loop path.  Cached per ``(n_banks, trials,
        overrides)`` like :meth:`isa`; ``track_unshared`` is forced off."""
        from .fused import FusedBankSim, FusedPudIsa
        k = self.banks if n_banks is None else int(n_banks)
        if not 1 <= k <= self.banks:
            raise ValueError(f"n_banks must be in 1..{self.banks}, got {k}")
        t = self.trials if trials is ... else trials
        if t is None or int(t) < 1:
            raise ValueError("fused execution is trial-batched: trials "
                             f"must be >= 1 per bank, got {t}")
        key = (k, t, tuple(sorted(overrides.items())))
        if key not in self._fused:
            kw = {**self._sim_kwargs, **overrides}
            kw.pop("track_unshared", None)
            with trace.span("pud.chip"):
                sim = FusedBankSim(self.module,
                                   bank_seeds=self.bank_seeds[:k],
                                   trials=int(t), **kw)
                self._fused[key] = FusedPudIsa(sim)
        return self._fused[key]

    def __getitem__(self, bank: int) -> PudIsa:
        return self.isa(bank)

    @property
    def isas(self) -> list[PudIsa]:
        """Default-trials ISA of every bank (builds any missing sims)."""
        return [self.isa(b) for b in range(self.banks)]

    def shard(self, n_items: int) -> list[list[int]]:
        """Round-robin item indices per bank (item i -> bank i % N)."""
        return [list(range(b, n_items, self.banks))
                for b in range(self.banks)]

    def next_noise_seed(self, bank: int = 0) -> int:
        """A fresh deterministic noise-stream seed for one bank's next
        episode (bank 0's stream is the single-bank one)."""
        child = self._noise_seqs[bank].spawn(1)[0]
        return int(child.generate_state(1, np.uint64)[0])

    def reseed_noise(self, bank: int | None = None) -> None:
        """Restart every constructed sim of one bank (or all banks) on a
        fresh independent noise stream."""
        for (b, *_), isa in self._isas.items():
            if bank is None or b == bank:
                isa.sim.reseed_noise(self.next_noise_seed(b))

    # ------------- modeled concurrent-bank time -------------
    def bank_time_ns(self) -> list[float]:
        """Per-bank simulated command time (sum over that bank's sims); a
        fused sim's log time accrues to each of its banks ``0..k-1``."""
        out = [0.0] * self.banks
        for (b, *_), isa in self._isas.items():
            out[b] += isa.sim.log.time_ns
        for (k, *_), fisa in self._fused.items():
            t = fisa.sim.log.time_ns
            for b in range(k):
                out[b] += t
        return out

    def makespan_ns(self) -> float:
        """Optimistic modeled array time: banks run concurrently, so the
        array finishes with its slowest bank (no tRRD/tFAW arbitration,
        no refresh)."""
        return max(self.bank_time_ns())

    def legal_makespan_ns(self) -> float:
        """Rank-legal array execution time: the makespan of the
        :func:`repro_torch.analysis.schedule_bank_array` event-driven
        schedule of this array's command logs — per-bank serial order
        preserved, cross-bank ACTs arbitrated under tRRD/tFAW, REF injected
        every tREFI.  Always >= :meth:`makespan_ns`."""
        from .. import analysis     # analysis sits above core
        return float(analysis.schedule_bank_array(self).legal_makespan_ns)

    def total_time_ns(self) -> float:
        """Sum of per-bank times — what one bank would have taken."""
        return float(sum(self.bank_time_ns()))

    # ------------- shared scheduling across banks -------------
    def schedule_decisions(self, prog: CC.Program, *,
                           trials: int | None = ...,
                           pin_inputs: bool = False,
                           duplicate: bool | None = None) -> tuple:
        """Run the scheduler search once on bank 0 (memoized in
        ``compiler._SCHED_CACHE``) and return the frozen
        ``(order, forms, dup_hints, dup_enabled)`` decisions for replay
        on sibling banks via ``schedule_resident(_fixed=...)``."""
        return CC.shared_schedule_decisions(
            prog, self.isa(0, trials), pin_inputs=pin_inputs,
            duplicate=duplicate)

    def sessions(self, prog: CC.Program, *, trials: int | None = ...,
                 policy: ResidentPolicy = ResidentPolicy.SCHEDULED,
                 pin_inputs: bool | None = None,
                 duplicate: bool | None = None
                 ) -> list[CC.ResidentSession]:
        """One ResidentSession per bank over this program.  Under the
        scheduled policy the (order, form, duplication) search runs once
        on bank 0 and every bank replays the frozen decisions; each bank
        still plans its own rows/pairs (plans are seed-dependent)."""
        policy = coerce_resident(policy, where="BankArray.sessions")
        fixed = None
        if policy is ResidentPolicy.SCHEDULED:
            pins = (True if pin_inputs is None else pin_inputs)
            fixed = self.schedule_decisions(prog, trials=trials,
                                            pin_inputs=pins,
                                            duplicate=duplicate)
        return [CC.ResidentSession(prog, self.isa(b, trials),
                                   policy=policy.value, pin_inputs=pin_inputs,
                                   duplicate=duplicate, fixed=fixed)
                for b in range(self.banks)]

    # ------------- cross-bank reduction tree -------------
    def _planes(self, p) -> torch.Tensor:
        return torch.as_tensor(p, device=self.device).to(torch.uint8)

    def _run_add(self, bank: int, a: torch.Tensor, b: torch.Tensor,
                 policy: ResidentPolicy) -> torch.Tensor:
        """(k, ...) + (k, ...) -> (k+1, ...) on one bank's adder."""
        k = a.shape[0]
        prog = _adder_program(k)
        ins = {f"a{i}": a[i] for i in range(k)} \
            | {f"b{i}": b[i] for i in range(k)}
        isa = self.isa(bank)
        plan = None
        if policy is ResidentPolicy.SCHEDULED:
            # search once per adder width on bank 0, replay elsewhere
            fixed = self.schedule_decisions(prog, trials=self.trials)
            plan = CC.schedule_resident(prog, isa, policy="scheduled",
                                        _fixed=None if bank == 0 else fixed)
        out = CC.run_sim(prog, ins, isa, resident=policy, plan=plan)
        return torch.stack([out[f"s{i}"] for i in range(k)] + [out["cout"]])

    def tree_reduce_add(self, planes_per_bank: list, *,
                        policy: ResidentPolicy | None = None
                        ) -> tuple[torch.Tensor, int]:
        """Sum per-bank bit-plane numbers with a binary reduction tree.

        ``planes_per_bank[b]`` is bank b's operand: a ``(k_b, w)`` (or
        trial-batched ``(k_b, T, w)``) {0,1} LSB-first plane stack (numpy
        or tensor).  Round r merges bank pairs at stride ``2**r``: the
        destination (lower-indexed) bank runs a ripple-carry add of its own
        planes and the source bank's, whose output planes arrive through
        the host.  Returns ``(sum_planes, bank)`` — the final
        ``(k+ceil(log2 N), ...)`` uint8 plane stack on the array's device
        and the bank holding it.  Empty operands (``k_b == 0``) are
        skipped."""
        policy = coerce_resident(policy, where="BankArray.tree_reduce_add",
                                 default=ResidentPolicy.SCHEDULED)
        if len(planes_per_bank) != self.banks:
            raise ValueError(f"want one operand per bank "
                             f"({self.banks}), got {len(planes_per_bank)}")
        live = [(b, self._planes(p)) for b, p in enumerate(planes_per_bank)
                if np.shape(p)[0]]
        if not live:
            raise ValueError("tree_reduce_add of all-empty operands")
        while len(live) > 1:
            nxt = []
            for i in range(0, len(live) - 1, 2):
                (db, a), (_sb, b) = live[i], live[i + 1]
                k = max(a.shape[0], b.shape[0])
                pad = [torch.zeros_like(x[:1]) for x in (a, b)]
                a = torch.cat([a] + pad[0:1] * (k - a.shape[0]))
                b = torch.cat([b] + pad[1:2] * (k - b.shape[0]))
                nxt.append((db, self._run_add(db, a, b, policy)))
            if len(live) % 2:
                nxt.append(live[-1])
            live = nxt
        return live[0][1], live[0][0]

    def popcount(self, bit_planes_per_bank: list, *,
                 policy: ResidentPolicy | None = None
                 ) -> tuple[torch.Tensor, int]:
        """Cross-bank popcount accumulation: each bank counts its own
        single-bit planes with an in-bank adder tree
        (``compiler.popcount_exprs``), then the per-bank partial counts
        combine through :meth:`tree_reduce_add`.  Returns the count
        planes (LSB first) and the bank holding them."""
        policy = coerce_resident(policy, where="BankArray.popcount",
                                 default=ResidentPolicy.SCHEDULED)
        partial: list[torch.Tensor] = []
        for b, planes in enumerate(bit_planes_per_bank):
            planes = self._planes(planes)
            n = planes.shape[0]
            if n == 0:
                partial.append(planes)
                continue
            prog = _popcount_program(n)
            ins = {f"x{i}": planes[i] for i in range(n)}
            plan = None
            if policy is ResidentPolicy.SCHEDULED:
                fixed = self.schedule_decisions(prog, trials=self.trials)
                plan = CC.schedule_resident(
                    prog, self.isa(b), policy="scheduled",
                    _fixed=None if b == 0 else fixed)
            out = CC.run_sim(prog, ins, self.isa(b), resident=policy,
                             plan=plan)
            partial.append(torch.stack([out[f"c{i}"]
                                        for i in range(len(out))]))
        return self.tree_reduce_add(partial, policy=policy)
