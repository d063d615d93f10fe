"""DDR4 command-log timing linter (the port of ``repro.analysis.timing``).

The simulator's :class:`~repro_torch.core.simulator.CommandLog` records
*logical* commands (WR, RD, RC, FRAC, APA) with modeled durations.  This
module expands each logical command into its primitive DDR4 sequence
(ACT / RD / WR / PRE at modeled offsets) and lints the stream against
JEDEC-style timing rules — the same :class:`TimingRule`/
:class:`TimingChecker` shape real memory-controller models use.

The PuD protocols *deliberately* violate tRAS/tRP inside RowClone, Frac
and APA sequences (the paper's whole premise); those primitive gaps are
tagged ``by_design`` and tallied separately from genuine ``violations``.
The cost model also idealizes plain WR/RD occupancy at
``tRCD + tWR/tCL + tRP``, which undershoots the tRAS a standards
controller would wait out — those gaps are tagged ``deficit`` and the
shortfall is reported in nanoseconds rather than counted as a violation
(it quantifies the cost model's optimism, not a bug).

Cross-bank, :func:`lint_bank_array` merges the per-bank ACT streams of a
:class:`~repro_torch.core.bankarray.BankArray` and quantifies how optimistic
the *optimistic* ``makespan_ns`` model (banks all start at t=0) is under
the rank-level tRRD / tFAW ACT-rate limits, reporting conflict counts
(:func:`rank_conflicts`, a sliding-window scan) and a minimum legal
makespan lower bound (:func:`act_rate_bound`).
:mod:`repro_torch.analysis.schedule` turns the same per-bank streams into a
*legal* rank schedule —
``BankArray.legal_makespan_ns()`` reports the resulting makespan next to
the optimistic one, and the scheduled stream re-lints to zero conflicts
by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.device import (DRAMTimings, VIOLATED_TRAS_NS, VIOLATED_TRP_NS,
                           timings_for)

__all__ = ["TimingRule", "TimingChecker", "TimingReport",
           "ArrayTimingReport", "act_rate_bound", "ddr4_rules",
           "expand_log", "lint_bank_array", "rank_conflicts"]

#: float-compare slack: boundary-exact gaps (== tRP etc.) are legal
_EPS = 1e-9


@dataclass(frozen=True)
class Primitive:
    """One primitive DDR4 command on the expanded timeline.

    ``legality`` tags the *gap ending at this primitive*: ``ok`` must
    satisfy the rules, ``by_design`` is a deliberate PuD timing
    violation, ``deficit`` marks the cost model's idealized WR/RD
    occupancy (tRAS undershoot, reported but not a violation)."""

    t: float
    kind: str            # ACT | PRE | RD | WR
    bank: int
    sub: int
    legality: str = "ok"


@dataclass(frozen=True)
class TimingRule:
    """Minimum separation ``min_ns`` between a ``prev``-kind primitive
    and a following ``curr``-kind primitive.  ``scope="bank"`` rules
    apply within one bank's serial stream; ``scope="rank"`` rules apply
    to the merged cross-bank stream (ACT-rate limits)."""

    rule_id: str
    name: str
    prev: str
    curr: tuple[str, ...]
    min_ns: float
    scope: str = "bank"


def ddr4_rules(t: DRAMTimings) -> tuple[TimingRule, ...]:
    """The lint rule set for one speed grade."""
    return (
        TimingRule("TIME-TRCD", "ACT to column command", "ACT",
                   ("RD", "WR"), t.tRCD),
        TimingRule("TIME-TRAS", "ACT to PRE", "ACT", ("PRE",), t.tRAS),
        TimingRule("TIME-TRP", "PRE to ACT", "PRE", ("ACT",), t.tRP),
        TimingRule("TIME-TWR", "write recovery", "WR", ("PRE",), t.tWR),
        TimingRule("TIME-TRRD", "ACT to ACT, same bank group", "ACT",
                   ("ACT",), t.tRRD, scope="rank"),
        TimingRule("TIME-TFAW", "four-activate window", "ACT", ("ACT",),
                   t.tFAW, scope="rank"),
    )


def _expand_one(ev, t: DRAMTimings):
    """(offset, kind, legality) primitives of one logical command.

    Offsets mirror the simulator's modeled durations exactly: every
    command ends one tRP after its final PRE, so back-to-back commands
    in a serial log satisfy tRP at the boundary by construction."""
    v_ras, v_rp = VIOLATED_TRAS_NS, VIOLATED_TRP_NS
    if ev.cmd == "WR":
        # tRCD + tWR occupancy idealizes away the tRAS tail -> deficit
        return ((0.0, "ACT", "ok"), (t.tRCD, "WR", "ok"),
                (t.tRCD + t.tWR, "PRE",
                 "deficit" if t.tRCD + t.tWR < t.tRAS else "ok"))
    if ev.cmd == "RD":
        return ((0.0, "ACT", "ok"), (t.tRCD, "RD", "ok"),
                (t.tRCD + t.tCL, "PRE",
                 "deficit" if t.tRCD + t.tCL < t.tRAS else "ok"))
    if ev.cmd == "RC":
        # ACT -> PRE -> ACT with violated tRP between the activations
        return ((0.0, "ACT", "ok"), (t.tRAS, "PRE", "ok"),
                (t.tRAS + v_rp, "ACT", "by_design"),
                (t.tRAS + v_rp + t.tRAS, "PRE", "ok"))
    if ev.cmd == "FRAC":
        # two violated-tRAS ACT -> PRE pulses (FracDRAM VDD/2 charge)
        return ((0.0, "ACT", "ok"), (v_ras, "PRE", "by_design"),
                (v_ras + t.tRP, "ACT", "ok"),
                (v_ras + t.tRP + v_ras, "PRE", "by_design"))
    if ev.cmd == "APA":
        # ACT -> PRE -> ACT; the first ACT's dwell is recoverable from
        # the logged duration (tRAS when the NOT protocol restored it,
        # the violated value otherwise)
        t_first = ev.t_ns - (v_rp + t.tRAS + t.tRP)
        return ((0.0, "ACT", "ok"),
                (t_first, "PRE",
                 "by_design" if t_first < t.tRAS - _EPS else "ok"),
                (t_first + v_rp, "ACT", "by_design"),
                (t_first + v_rp + t.tRAS, "PRE", "ok"))
    return ()        # opaque commands (APA+WR) only advance the clock


def expand_log(log, timings: DRAMTimings, *, bank: int | None = None,
               t0: float = 0.0) -> list[Primitive]:
    """Expand a CommandLog's event stream into timestamped primitives.

    Events replay serially (the log *is* one bank's serial command
    stream): each logical command starts where the previous one ended.
    ``bank`` overrides the recorded issuing bank (used when a fused
    sim's bank-stacked log is replicated onto each member bank);
    ``t0`` offsets the whole stream (concatenating multiple sims'
    logs on one bank's timeline).
    """
    out: list[Primitive] = []
    cursor = t0
    for ev in log.events:
        prims = _expand_one(ev, timings)
        b = ev.bank if bank is None else bank
        for _ in range(ev.count):
            for dt, kind, legality in prims:
                out.append(Primitive(cursor + dt, kind, b, ev.sub,
                                     legality))
            cursor += ev.t_ns
    return out


@dataclass
class TimingReport:
    """Per-rule lint tallies of one primitive stream."""

    violations: dict[str, int] = field(default_factory=dict)
    by_design: dict[str, int] = field(default_factory=dict)
    deficits: dict[str, int] = field(default_factory=dict)
    deficit_ns: float = 0.0
    n_primitives: int = 0
    n_acts: int = 0
    span_ns: float = 0.0
    #: whole refresh intervals elapsed without a REF (the logs carry no
    #: refresh traffic; informational — see TIME-TREFI)
    refresh_debt: int = 0
    #: tREFI of the rule set that linted this stream (0 = unknown);
    #: lets :meth:`merge` recompute ``refresh_debt`` from the merged span
    trefi_ns: float = 0.0

    @property
    def total_violations(self) -> int:
        return sum(self.violations.values())

    def merge(self, other: "TimingReport") -> "TimingReport":
        for key in ("violations", "by_design", "deficits"):
            mine, theirs = getattr(self, key), getattr(other, key)
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v
        self.deficit_ns += other.deficit_ns
        self.n_primitives += other.n_primitives
        self.n_acts += other.n_acts
        self.span_ns = max(self.span_ns, other.span_ns)
        # merged streams run concurrently on one wall clock: the debt is
        # a property of the merged span, not a per-stream sum (summing
        # double-counts every shared refresh interval)
        self.trefi_ns = max(self.trefi_ns, other.trefi_ns)
        if self.trefi_ns > 0.0:
            self.refresh_debt = int(self.span_ns // self.trefi_ns)
        else:
            self.refresh_debt = max(self.refresh_debt, other.refresh_debt)
        return self


class TimingChecker:
    """Lints primitive command streams against a DDR4 rule set.

    Bank-scope rules walk one bank's serial stream tracking the last
    time each primitive kind issued; a ``curr`` primitive closer than
    ``min_ns`` to the last ``prev`` counts against the rule — into
    ``violations`` for an ``ok`` primitive, ``by_design`` for a
    deliberate PuD violation, ``deficits`` (+ total shortfall ns) for
    the cost model's idealized WR/RD occupancy.  Rank-scope rules
    (tRRD, tFAW) are applied by :func:`lint_bank_array` on the merged
    cross-bank ACT stream.
    """

    def __init__(self, timings: DRAMTimings | object,
                 rules: tuple[TimingRule, ...] | None = None):
        if not isinstance(timings, DRAMTimings):
            timings = timings_for(timings)
        self.timings = timings
        self.rules = tuple(rules) if rules is not None \
            else ddr4_rules(timings)
        self.bank_rules = tuple(r for r in self.rules if r.scope == "bank")

    def lint(self, stream) -> TimingReport:
        """Lint one serial stream: a CommandLog or a Primitive list."""
        if hasattr(stream, "events"):
            stream = expand_log(stream, self.timings)
        rep = TimingReport()
        last: dict[str, float] = {}
        for p in stream:
            rep.n_primitives += 1
            if p.kind == "ACT":
                rep.n_acts += 1
            for rule in self.bank_rules:
                if p.kind not in rule.curr:
                    continue
                prev_t = last.get(rule.prev)
                if prev_t is None:
                    continue
                gap = p.t - prev_t
                if gap < rule.min_ns - _EPS:
                    if p.legality == "by_design":
                        rep.by_design[rule.rule_id] = \
                            rep.by_design.get(rule.rule_id, 0) + 1
                    elif p.legality == "deficit":
                        rep.deficits[rule.rule_id] = \
                            rep.deficits.get(rule.rule_id, 0) + 1
                        rep.deficit_ns += rule.min_ns - gap
                    else:
                        rep.violations[rule.rule_id] = \
                            rep.violations.get(rule.rule_id, 0) + 1
            last[p.kind] = p.t
            rep.span_ns = max(rep.span_ns, p.t)
        rep.trefi_ns = self.timings.tREFI
        rep.refresh_debt = int(rep.span_ns // self.timings.tREFI)
        return rep


@dataclass
class ArrayTimingReport:
    """Cross-bank lint of a BankArray's command logs.

    ``per_bank`` lints every bank's serial stream independently (their
    ``total_violations`` must be zero for any well-formed log — the
    benchmark gate).  The rank-level fields quantify the optimistic
    makespan model's optimism: banks all start at t=0, so the merged
    ACT stream ignores tRRD / tFAW; ``trrd_conflicts`` /
    ``tfaw_conflicts`` count the collisions
    (:func:`rank_conflicts`) and ``min_legal_makespan_ns`` bounds the
    makespan any stream-preserving rank schedule needs
    (:func:`act_rate_bound`; a lower bound — the actual legal schedule
    is :func:`repro_torch.analysis.schedule.schedule_bank_array`)."""

    per_bank: list[TimingReport]
    trrd_conflicts: int = 0
    tfaw_conflicts: int = 0
    makespan_ns: float = 0.0
    min_legal_makespan_ns: float = 0.0

    @property
    def violations(self) -> int:
        """Total per-bank serial violations (0 on well-formed logs)."""
        return sum(r.total_violations for r in self.per_bank)

    @property
    def optimism_pct(self) -> float:
        """How much longer the rate-legal lower bound is vs the shipped
        independent-bank makespan, in percent."""
        if self.makespan_ns <= 0.0:
            return 0.0
        return 100.0 * (self.min_legal_makespan_ns - self.makespan_ns) \
            / self.makespan_ns


def bank_logs(array) -> list[tuple[int, object]]:
    """``(bank, CommandLog)`` of every sim an array has built, in
    construction order (a bank's sims run serially in that order)."""
    return [(b, isa.sim.log) for (b, *_), isa in array._isas.items()]


def _bank_streams(array) -> dict[int, list[Primitive]]:
    """Per-bank primitive timelines of every sim an array has built.

    Mirrors ``BankArray.bank_time_ns``: one bank's sims concatenate
    serially."""
    t = timings_for(array.module)
    streams: dict[int, list[Primitive]] = {b: [] for b in range(array.banks)}
    cursor = dict.fromkeys(streams, 0.0)
    for b, log in bank_logs(array):
        streams[b].extend(expand_log(log, t, bank=b, t0=cursor[b]))
        cursor[b] += log.time_ns
    for s in streams.values():
        s.sort(key=lambda p: p.t)
    return streams


def rank_conflicts(acts, t: DRAMTimings) -> tuple[int, int]:
    """(tRRD, tFAW) conflict counts of a time-sorted merged ACT stream.

    Sliding-window scans, counted per arriving ACT:

    * **tRRD** — an ACT closer than tRRD to *any* earlier ACT of a
      different bank counts once (an adjacent-pair scan would miss a
      different-bank pair inside one tRRD window whenever a same-bank
      ACT interleaves between them).
    * **tFAW** — an ACT whose trailing tFAW window holds more than four
      ACTs counts once, unless the whole window is a single bank's
      stream (a deliberate PuD burst is ``by_design``, rank pressure
      only exists across banks).
    """
    trrd = tfaw = 0
    window: list = []           # ACTs within the trailing tFAW window
    for p in acts:
        while window and p.t - window[0].t >= t.tFAW - _EPS:
            window.pop(0)
        # tRRD window is shorter than tFAW's, so scan newest-first
        # inside it and stop at the first ACT out of tRRD range
        for q in reversed(window):
            if p.t - q.t >= t.tRRD - _EPS:
                break
            if q.bank != p.bank:
                trrd += 1
                break
        window.append(p)
        if len(window) > 4 and len({q.bank for q in window}) > 1:
            tfaw += 1
    return trrd, tfaw


#: minimum tail from a stream's last ACT to its end: the shortest
#: expansion (Frac's second pulse) closes with a violated-tRAS dwell
#: plus the trailing tRP every modeled duration includes
_ACT_TAIL_NS = VIOLATED_TRAS_NS


def act_rate_bound(n_acts: int, t: DRAMTimings) -> float:
    """Lower-bounds the makespan of *any* stream-preserving schedule of
    ``n_acts`` rank ACTs.

    Only the four-activate window yields a sound per-ACT rate bound
    here: tFAW is enforced rank-wide (``a[i+4] >= a[i] + tFAW``), so the
    last ACT issues no earlier than ``floor((n-1)/4) * tFAW``, and the
    stream runs at least the shortest command tail past it.  A tRRD
    term would be unsound — same-bank by-design ACT pairs (RowClone,
    Frac, APA) are deliberately closer than tRRD, so ``(n-1) * tRRD``
    over-counts on exactly the streams this repo produces."""
    if n_acts <= 0:
        return 0.0
    return ((n_acts - 1) // 4) * t.tFAW + _ACT_TAIL_NS + t.tRP


def lint_bank_array(array, *, timings: DRAMTimings | None = None
                    ) -> ArrayTimingReport:
    """Lint every bank of a BankArray plus the rank-level ACT limits."""
    t = timings or timings_for(array.module)
    checker = TimingChecker(t)
    streams = _bank_streams(array)
    per_bank = [checker.lint(streams[b]) for b in range(array.banks)]
    # rank scope: merge all banks' ACTs on the shared (optimistic) t=0
    # timeline and count tRRD / tFAW collisions
    acts = sorted((p for s in streams.values() for p in s
                   if p.kind == "ACT"), key=lambda p: p.t)
    trrd, tfaw = rank_conflicts(acts, t)
    makespan = float(array.makespan_ns())
    bound = max(makespan, act_rate_bound(len(acts), t))
    return ArrayTimingReport(per_bank=per_bank, trrd_conflicts=trrd,
                             tfaw_conflicts=tfaw, makespan_ns=makespan,
                             min_legal_makespan_ns=bound)
