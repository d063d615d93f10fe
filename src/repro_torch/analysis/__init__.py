"""Static analysis of compiled plans and DRAM command logs.

Two passes, both *static* — they run before (or without) any simulated
execution:

* :mod:`repro_torch.analysis.verify` — SSA well-formedness of
  :class:`~repro_torch.core.compiler.Program` and a symbolic row-liveness
  replay of :class:`~repro_torch.core.compiler.ResidentPlan` micro-ops (row
  aliasing, use-after-evict, clone clobbering, polarity mismatches,
  pinned-pair conflicts, exact command-log reconciliation).
* :mod:`repro_torch.analysis.timing` — a DDR4 timing-rule linter
  (tRCD/tRAS/tRP/tWR/tRRD/tFAW/tREFI) over
  :class:`~repro_torch.core.simulator.CommandLog` event streams, per bank and
  cross-bank over a :class:`~repro_torch.core.bankarray.BankArray`.
* :mod:`repro_torch.analysis.schedule` — an event-driven rank-legal command
  scheduler over the same per-bank streams: cross-bank ACT arbitration
  under tRRD/tFAW, REF injection every tREFI, yielding a
  :class:`~repro_torch.analysis.schedule.ScheduledTimeline` whose
  ``legal_makespan_ns`` sits next to the optimistic independent-bank
  makespan (and whose scheduled stream re-lints to zero conflicts).

The port of ``repro.analysis``: pure Python over the port's programs,
plans and command logs, kept as its own copy (the port imports nothing of
``repro``), so findings, lint tallies and schedules equal the reference's
on equal inputs.

Diagnostics are structured :class:`Finding` records with stable rule
IDs (``PLAN-ROW-ALIAS``, ``TIME-TFAW``, ...) — tests and CI gates match
on ``Finding.rule``, never on message text.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass

__all__ = [
    "Severity", "Finding", "default_verify",
    "verify_program", "verify_plan", "PlanVerificationError",
    "TimingRule", "TimingChecker", "TimingReport", "ArrayTimingReport",
    "act_rate_bound", "ddr4_rules", "expand_log", "lint_bank_array",
    "rank_conflicts",
    "CommandBlock", "ScheduledCommand", "BankTimeline",
    "ScheduledTimeline", "command_blocks", "schedule_blocks",
    "schedule_bank_array",
]

#: severity levels, ordered: ERROR findings fail verification/gates,
#: WARNING findings are reported but do not fail, INFO is advisory
ERROR, WARNING, INFO = "error", "warning", "info"
Severity = str


@dataclass(frozen=True)
class Finding:
    """One structured diagnostic from a static-analysis pass.

    ``rule`` is a stable machine-matchable ID (``PLAN-ROW-ALIAS``,
    ``TIME-TRRD``, ...); ``site`` locates the defect (step index, micro-op,
    row, or command sequence index — pass-specific but structured);
    ``message`` is for humans only and must never be matched on.
    """

    rule: str
    severity: Severity
    site: tuple = ()
    message: str = ""

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return f"[{self.severity}] {self.rule} @ {self.site}: {self.message}"


def default_verify() -> bool:
    """The tri-state resolution of ``verify=None``.

    The ``FCDRAM_VERIFY`` environment variable wins when set (``1``/
    ``true``/``on`` force-enables, ``0``/``false``/``off`` disables);
    otherwise verification is on exactly when pytest is driving the
    process (tests/debug) and off everywhere else (benchmarks, MC
    characterization), so the hot paths never pay the replay cost
    unless asked to.
    """
    env = os.environ.get("FCDRAM_VERIFY")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "off", "no")
    return "pytest" in sys.modules


from .verify import (  # re-export after Finding exists
    PlanVerificationError, verify_plan, verify_program)
from .timing import (
    ArrayTimingReport, TimingChecker, TimingReport, TimingRule,
    act_rate_bound, ddr4_rules, expand_log, lint_bank_array,
    rank_conflicts)
from .schedule import (
    BankTimeline, CommandBlock, ScheduledCommand, ScheduledTimeline,
    command_blocks, schedule_bank_array, schedule_blocks)
