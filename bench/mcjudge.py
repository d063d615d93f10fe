"""A Monte-Carlo traffic kind: the program's entry point, its reference,
and the judgement of its success rates, shared by the MC drivers.

A driver file (``bench/drivers/<kind>.py``) names one :class:`McDriver` as
``DRIVER`` (the contract: ``bench/drivers/__init__.py``).  The harness calls
``DRIVER.call`` in the window and hands ``DRIVER.judge`` the calls it drew
for the judgement; the judgement here calls the program once more on each
drawn call's seed, keeping the result rows it scores
(``bench.program.result_rows``), recomputes the chip with the reference
(``bench/reference``) and compares:

* ``rate_gap``: the largest |rate - reference| over the drawn calls, the
  window's rate and the one made again, each against its own seed's;
* ``row_mismatch``: the largest count of result bits that differ from the
  reference's in one drawn call.

:meth:`McDriver.control` is the same traffic with the reference, its
decision in a lower precision, put in the program's place: the control
that has to come out not correct.  The MC kinds make nothing in set-up:
every call is a new chip, made from the call's own seed.
"""
from __future__ import annotations

import copy
import sys
import traceback

import torch

from bench import program

#: the CPU tests' sizes: rows of 256 bits, 96 trials a call (480 above 9
#: groups)
SMALL_ROW_BITS = 256
#: the CPU tests' rows at which the bfloat16 control is caught (16x the
#: small rows)
CONTROL_ROW_BITS = 4096


def small_trials(mix: dict) -> int:
    return 480 if mix["groups"] > 9 else 96


def _with_rows(cfg: dict, row_bits: int) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["module"]["row_bits"] = row_bits
    return cfg


def rounds(cfg: dict, mix: dict) -> list[int]:
    """The banks of each scored block of one call: one group a block on one
    bank, or, where the banks fuse (the default for more than one bank),
    rounds of up to ``banks`` groups."""
    banks = cfg["banks"]
    if banks > 1 and cfg["fused"] is not False:
        full, tail = divmod(mix["groups"], banks)
        return [banks] * full + ([tail] if tail else [])
    return [1] * mix["groups"]


def flip_one_result_bit(monkeypatch) -> None:
    """The ISA's readout hands back each result word with one bit flipped."""
    from repro_torch.core.isa import PudIsa
    read = PudIsa._result_word

    def altered(self, *a, **k):
        word = read(self, *a, **k).clone()
        word.view(-1)[0] ^= 1
        return word

    monkeypatch.setattr(PudIsa, "_result_word", altered)


def half_the_batch(monkeypatch) -> None:
    """The entry points run half the trials asked for, and score those."""
    from repro_torch.core import charz
    for entry in ("mc_boolean_success", "mc_not_success"):
        full = getattr(charz, entry)

        def halved(*a, _full=full, **k):
            return _full(*a, **dict(k, trials=k["trials"] // 2))

        monkeypatch.setattr(charz, entry, halved)


def row_mismatch(rows: torch.Tensor, ref_rows: torch.Tensor) -> int:
    """Result bits that differ from the reference's; rows of another shape
    differ everywhere."""
    if rows.shape != ref_rows.shape:
        return max(rows.numel(), ref_rows.numel())
    return int((rows.to(ref_rows.device) != ref_rows).sum())


class McDriver:
    """``entry(cfg, mix, seed, device) -> rate`` is the program's call;
    ``reference(cfg, mix, seed, device, dtype) -> (rate, rows)`` the plain
    one; ``limits`` the limit of each number compared; ``apas(cfg, mix)``
    the sense-amp resolves of one call (for ``senseamp_roofline``)."""

    faults = (flip_one_result_bit, half_the_batch)

    def __init__(self, entry, reference, limits: dict, apas):
        self.entry, self.reference = entry, reference
        self.limits, self.apas = dict(limits), apas

    def call(self, cfg, mix, seed, device) -> float:
        return self.entry(cfg, mix, seed, device)

    def answer(self, cfg, mix, seed, device):
        """One call again, with the result rows it scored, stacked."""
        with program.result_rows() as kept:
            rate = self.call(cfg, mix, seed, device)
        rows = torch.cat(kept) if kept else torch.zeros(0, dtype=torch.uint8)
        return rate, rows

    def judge(self, cfg, mix, calls, device, log=sys.stderr) -> dict:
        """``calls``: the drawn ``(seed, rate)`` of the window (one at
        least), ``rate`` None for a call that failed.  -> ``{name: {value,
        limit}}``."""
        gap, mismatch = 0.0, 0
        paper = mix.get("paper")
        for seed, rate in calls:
            ref_rate, ref_rows = self.reference(cfg, mix, seed, device)
            try:
                again, rows = self.answer(cfg, mix, seed, device)
            except Exception:       # the program failed: no rate, no rows
                traceback.print_exc()
                again, rows = None, torch.zeros(0, dtype=torch.uint8)
            # a rate is in [0, 1]: a call that gave none is as far off as any
            gap = max(gap, *(1.0 if r is None else abs(r - ref_rate)
                             for r in (rate, again)))
            mismatch = max(mismatch, row_mismatch(rows, ref_rows))
            print(f"[rate] seed {seed}: program {rate!r} (again {again!r}), "
                  f"reference {ref_rate!r}"
                  + (f"; paper {paper['success']} ({paper['where']}): "
                     f"simulator - paper {ref_rate - paper['success']:+.6f}"
                     if paper else ""), file=log)
            del ref_rows, rows
        return {"rate_gap": {"value": gap, "limit": self.limits["rate_gap"]},
                "row_mismatch": {"value": mismatch,
                                 "limit": self.limits["row_mismatch"]}}

    def control(self, dtype=torch.bfloat16) -> "McDriver":
        """The reference with its decision in ``dtype``, in the program's
        place."""
        return _Control(self, dtype)

    def small(self, cfg, mix):
        """Rows of ``SMALL_ROW_BITS``, trials by :func:`small_trials`."""
        return (_with_rows(cfg, SMALL_ROW_BITS),
                dict(mix, trials=small_trials(mix)))

    def small_control(self, cfg, mix):
        """The small trials on rows of ``CONTROL_ROW_BITS``."""
        cfg, mix = self.small(cfg, mix)
        return _with_rows(cfg, CONTROL_ROW_BITS), mix

    def host_reads(self, cfg, mix) -> int:
        """The host's reads of device data in one call: one score read a
        scored block and one op-context read a sense-amp resolve."""
        return len(rounds(cfg, mix)) + len(self.apas(cfg, mix))


class _Control(McDriver):
    def __init__(self, driver: McDriver, dtype):
        super().__init__(None, driver.reference, driver.limits, driver.apas)
        self.dtype = dtype

    def call(self, cfg, mix, seed, device) -> float:
        return self.answer(cfg, mix, seed, device)[0]

    def answer(self, cfg, mix, seed, device):
        return self.reference(cfg, mix, seed, device, self.dtype)
