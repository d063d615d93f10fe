"""Event-driven rank-legal command scheduler (the port of
``repro.analysis.schedule``).

The optimistic ``BankArray.makespan_ns()`` model starts every bank at
t=0 and ignores the rank: real DDR4 serializes cross-bank activates
under tRRD, caps them at four per tFAW window, and steals tRFC every
tREFI for refresh — PuD throughput is bounded by the command interface,
not per-bank energy.  This module turns the per-bank logical command
streams of a :class:`~repro_torch.core.bankarray.BankArray` into a *legal*
rank schedule and reports what legality actually costs.

Model
-----
Each logical command (WR / RD / RC / FRAC / APA) is a rigid *block*: its
primitive sequence (:func:`repro_torch.analysis.timing._expand_one`) keeps its
modeled intra-command offsets — the deliberate ``by_design`` gaps are
the PuD protocol and must not be stretched — and occupies its bank for
the modeled duration.  The scheduler assigns each block a start time
such that:

* **per-bank serial order** is preserved: a block starts no earlier
  than its bank's previous block ended (bank-scope timing therefore
  stays exactly as linted — delays only widen boundary gaps);
* **cross-bank ACT arbitration**: a block's first ACT issues at least
  tRRD after the latest ACT of any *other* bank, and every ACT obeys
  the strict four-activate window (``act >= 4th-previous act + tFAW``,
  rank-wide) — a superset of the lint's :func:`rank_conflicts` rules,
  so the scheduled stream re-lints to zero conflicts by construction;
* **refresh**: once issue time crosses a tREFI deadline, a REF window
  opens after all in-flight blocks precharge and blocks the rank for
  tRFC (deferred-refresh model: JEDEC allows postponing REF, so a
  command already underway completes first).

Arbitration is greedy earliest-issue: among the banks' next blocks, the
one that can legally start first wins (ties to the lower bank index),
which keeps issue times non-decreasing and the ACT history sorted.  Per
block the stall beyond its serial position is attributed to ``refresh``
(pushed past a REF window) or ``rank`` (pushed by tRRD / tFAW).

The resulting :class:`ScheduledTimeline` carries the proof obligation:
``relint_violations`` re-lints every bank's scheduled stream plus the
merged rank ACT stream (fixed sliding-window rules) and must be zero.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.device import DRAMTimings, timings_for
from .timing import (TimingChecker, _EPS, _expand_one, act_rate_bound,
                     bank_logs, rank_conflicts, Primitive)

__all__ = ["CommandBlock", "ScheduledCommand", "BankTimeline",
           "ScheduledTimeline", "command_blocks", "schedule_blocks",
           "schedule_bank_array"]


@dataclass(frozen=True)
class CommandBlock:
    """One logical command as a rigid schedulable unit.

    ``prims`` are (offset, kind, legality) triples relative to the block
    start; ``dur`` is the modeled occupancy (the simulator's logged
    ``t_ns``, which already ends one tRP after the final PRE).
    ``act_offs`` caches the ACT offsets the rank arbiter needs."""

    cmd: str
    bank: int
    sub: int
    dur: float
    prims: tuple
    act_offs: tuple

    @classmethod
    def from_event(cls, ev, t: DRAMTimings, bank: int) -> "CommandBlock":
        prims = _expand_one(ev, t)
        return cls(cmd=ev.cmd, bank=bank, sub=ev.sub, dur=float(ev.t_ns),
                   prims=prims,
                   act_offs=tuple(dt for dt, kind, _ in prims
                                  if kind == "ACT"))


def command_blocks(log, timings: DRAMTimings, *,
                   bank: int | None = None) -> list[CommandBlock]:
    """One bank's serial CommandLog as schedulable blocks.

    ``count > 1`` events repeat into ``count`` identical blocks (the
    serial replay semantics of :func:`repro_torch.analysis.timing.expand_log`);
    ``bank`` overrides the recorded issuing bank for fused logs
    replicated onto each member bank."""
    out: list[CommandBlock] = []
    for ev in log.events:
        b = ev.bank if bank is None else bank
        block = CommandBlock.from_event(ev, timings, b)
        out.extend([block] * ev.count)
    return out


@dataclass(frozen=True)
class ScheduledCommand:
    """One block with its assigned legal issue time and the stall it
    paid beyond its bank-serial position."""

    start: float
    block: CommandBlock
    rank_stall_ns: float = 0.0
    refresh_stall_ns: float = 0.0

    @property
    def end(self) -> float:
        return self.start + self.block.dur

    def primitives(self) -> list[Primitive]:
        b = self.block
        return [Primitive(self.start + dt, kind, b.bank, b.sub, legality)
                for dt, kind, legality in b.prims]


@dataclass
class BankTimeline:
    """Per-bank breakdown of one scheduled rank timeline."""

    bank: int
    serial_ns: float = 0.0       # sum of block durations (no stalls)
    end_ns: float = 0.0          # end of the bank's last block
    rank_stall_ns: float = 0.0   # waits caused by tRRD / tFAW arbitration
    refresh_stall_ns: float = 0.0  # waits caused by REF windows
    n_commands: int = 0
    n_acts: int = 0


@dataclass
class ScheduledTimeline:
    """A legal per-rank schedule of a BankArray's command streams."""

    timings: DRAMTimings
    commands: list[ScheduledCommand] = field(default_factory=list)
    per_bank: dict[int, BankTimeline] = field(default_factory=dict)
    #: REF blackout windows (start, end), each tRFC long
    refresh_windows: list[tuple[float, float]] = field(default_factory=list)
    legal_makespan_ns: float = 0.0
    #: the optimistic independent-bank makespan (max per-bank serial time)
    serial_makespan_ns: float = 0.0
    #: ACT-rate lower bound (:func:`repro_torch.analysis.timing.act_rate_bound`)
    min_legal_makespan_ns: float = 0.0
    n_acts: int = 0
    #: proof obligation: violations when the scheduled stream is re-linted
    #: (per-bank rules + fixed rank-level tRRD/tFAW scans); 0 by
    #: construction
    relint_violations: int = 0

    @property
    def refreshes(self) -> int:
        return len(self.refresh_windows)

    @property
    def refresh_ns(self) -> float:
        return sum(e - s for s, e in self.refresh_windows)

    @property
    def rank_stall_ns(self) -> float:
        """Total cross-bank arbitration stall, summed over banks."""
        return sum(b.rank_stall_ns for b in self.per_bank.values())

    @property
    def refresh_stall_ns(self) -> float:
        """Total refresh-induced stall, summed over banks."""
        return sum(b.refresh_stall_ns for b in self.per_bank.values())

    @property
    def legality_overhead_pct(self) -> float:
        """How much longer the legal makespan is than the optimistic
        independent-bank makespan, in percent."""
        if self.serial_makespan_ns <= 0.0:
            return 0.0
        return 100.0 * (self.legal_makespan_ns - self.serial_makespan_ns) \
            / self.serial_makespan_ns

    def primitives(self) -> list[Primitive]:
        """The merged scheduled primitive stream, time-sorted."""
        out = [p for sc in self.commands for p in sc.primitives()]
        out.sort(key=lambda p: p.t)
        return out

    def bank_stream(self, bank: int) -> list[Primitive]:
        out = [p for sc in self.commands if sc.block.bank == bank
               for p in sc.primitives()]
        out.sort(key=lambda p: p.t)
        return out

    def relint(self) -> int:
        """Re-lint the scheduled stream: per-bank serial rules plus the
        rank-level sliding-window scans on the merged ACT stream.
        Returns the total violation count (the zero-violation proof)."""
        checker = TimingChecker(self.timings)
        total = 0
        for b in self.per_bank:
            total += checker.lint(self.bank_stream(b)).total_violations
        acts = [p for p in self.primitives() if p.kind == "ACT"]
        trrd, tfaw = rank_conflicts(acts, self.timings)
        return total + trrd + tfaw


def _avoid_windows(s: float, dur: float,
                   windows: list[tuple[float, float]]) -> float:
    """Earliest start >= ``s`` whose occupancy misses every REF window."""
    for ws, we in windows:          # windows are built in ascending order
        if s + dur > ws + _EPS and s < we - _EPS:
            s = we
    return s


def _act_legal(s: float, block: CommandBlock, acts: list[float],
               last_other: float, t: DRAMTimings) -> float:
    """Earliest start >= ``s`` whose ACTs satisfy the rank rules.

    ``acts`` is the ascending rank-wide ACT history, ``last_other`` the
    latest ACT time of any other bank.  tRRD binds only the block's
    first ACT (later ones are even later); the strict four-activate
    window binds each of the block's ACTs against the history plus the
    block's own earlier ACTs."""
    offs = block.act_offs
    if not offs:
        return s
    if last_other > float("-inf"):
        s = max(s, last_other + t.tRRD - offs[0])
    if len(offs) > 4:
        # a rigid block with 5+ internal ACTs inside one tFAW window
        # could not be delayed into legality; _expand_one emits at most
        # two ACTs per command, so this cannot happen for real logs
        raise ValueError(f"unschedulable block: {len(offs)} ACTs in one "
                         f"rigid {block.cmd} command")
    for i, dt in enumerate(offs):
        # the i-th block ACT sees len(acts) + i predecessors; it must
        # trail the 4th-most-recent by tFAW.  Earlier block ACTs are at
        # s + offs[..i-1], later than any history entry once s settles,
        # so the 4th-most-recent is history[-(4 - i)].
        back = 4 - i
        if back > 0 and len(acts) >= back:
            s = max(s, acts[-back] + t.tFAW - dt)
    return s


def schedule_blocks(per_bank: dict[int, list[CommandBlock]],
                    timings: DRAMTimings, *,
                    serial_makespan_ns: float | None = None
                    ) -> ScheduledTimeline:
    """Schedule per-bank serial block lists onto one legal rank timeline.

    Greedy earliest-issue arbitration (see module docstring); the
    returned timeline's ``relint_violations`` is computed eagerly — the
    zero-violation proof ships with the schedule."""
    t = timings
    banks = sorted(per_bank)
    tl = ScheduledTimeline(timings=t)
    for b in banks:
        bt = BankTimeline(bank=b)
        bt.serial_ns = sum(bl.dur for bl in per_bank[b])
        bt.n_commands = len(per_bank[b])
        bt.n_acts = sum(len(bl.act_offs) for bl in per_bank[b])
        tl.per_bank[b] = bt
    tl.n_acts = sum(bt.n_acts for bt in tl.per_bank.values())
    tl.serial_makespan_ns = (max((bt.serial_ns
                                  for bt in tl.per_bank.values()),
                                 default=0.0)
                             if serial_makespan_ns is None
                             else float(serial_makespan_ns))

    idx = dict.fromkeys(banks, 0)
    ready = dict.fromkeys(banks, 0.0)
    acts: list[float] = []          # ascending rank-wide ACT history
    last_act = dict.fromkeys(banks, float("-inf"))
    next_ref = t.tREFI
    ref_free = 0.0                  # end of the latest REF window

    def earliest(b: int) -> tuple[float, float, float]:
        """(start, refresh_stall, rank_stall) of bank ``b``'s next block."""
        block = per_bank[b][idx[b]]
        other = max((last_act[bb] for bb in banks if bb != b),
                    default=float("-inf"))
        s, d_ref, d_rank = ready[b], 0.0, 0.0
        while True:
            s1 = _avoid_windows(s, block.dur, tl.refresh_windows)
            d_ref += s1 - s
            s2 = _act_legal(s1, block, acts, other, t)
            if s2 <= s1 + _EPS:
                return s1, d_ref, d_rank
            d_rank += s2 - s1
            s = s2      # a rank push may land inside a later REF window

    while True:
        pending = [b for b in banks if idx[b] < len(per_bank[b])]
        if not pending:
            break
        best = min(pending, key=lambda b: (earliest(b)[0], b))
        s, d_ref, d_rank = earliest(best)
        if s >= next_ref - _EPS:
            # a refresh interval elapsed before this issue: open the REF
            # window once every in-flight block has precharged
            ws = max(next_ref, ref_free,
                     max((ready[b] for b in banks), default=0.0))
            tl.refresh_windows.append((ws, ws + t.tRFC))
            ref_free = ws + t.tRFC
            next_ref += t.tREFI
            continue                # re-arbitrate under the new window
        block = per_bank[best][idx[best]]
        idx[best] += 1
        tl.commands.append(ScheduledCommand(
            start=s, block=block, rank_stall_ns=d_rank,
            refresh_stall_ns=d_ref))
        bt = tl.per_bank[best]
        bt.rank_stall_ns += d_rank
        bt.refresh_stall_ns += d_ref
        ready[best] = s + block.dur
        bt.end_ns = ready[best]
        for dt in block.act_offs:
            acts.append(s + dt)
            last_act[best] = s + dt

    tl.legal_makespan_ns = max(
        max((bt.end_ns for bt in tl.per_bank.values()), default=0.0),
        ref_free)
    tl.min_legal_makespan_ns = max(tl.serial_makespan_ns,
                                   act_rate_bound(tl.n_acts, t))
    tl.relint_violations = tl.relint()
    return tl


def schedule_bank_array(array, *, timings: DRAMTimings | None = None
                        ) -> ScheduledTimeline:
    """Legal rank schedule of every command log a BankArray has built.

    Mirrors the lint's :func:`~repro_torch.analysis.timing._bank_streams`
    serialization: one bank's sims concatenate in construction order; a
    fused sim's bank-stacked log is replicated onto each member bank."""
    t = timings or timings_for(array.module)
    per_bank: dict[int, list[CommandBlock]] = {
        b: [] for b in range(array.banks)}
    for b, log in bank_logs(array):
        per_bank[b].extend(command_blocks(log, t, bank=b))
    return schedule_blocks(per_bank, t,
                           serial_makespan_ns=float(array.makespan_ns()))
