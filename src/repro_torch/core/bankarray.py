"""BankArray: N independent per-bank chips behind one device-addressed API.

The port of ``repro.core.bankarray``'s device addressing.  Each bank is its
own chip identity (decoder map + static sense-amp offsets) with its own
noise streams, derived from the array seed exactly as in the reference:
bank 0 uses ``seed`` itself (so ``BankArray(banks=1)`` is a plain
``BankSim(seed=seed)``), banks 1..N-1 take seeds from the spawn children
of ``SeedSequence([seed, 0xBA2C5])``.  The modeled array time is the
makespan over the per-bank command logs.

Not ported yet: the fused bank-stacked ISA, the rank-legal makespan, the
shared schedule decisions and resident sessions, and the cross-bank
reduction tree (``tree_reduce_add`` / ``popcount``).
"""
from __future__ import annotations

import numpy as np

from .device import get_module
from .isa import PudIsa
from .simulator import BankSim


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
            sim = BankSim(self.module, seed=self.bank_seeds[bank], bank=bank,
                          trials=t, **{**self._sim_kwargs, **overrides})
            self._isas[key] = PudIsa(sim, bank=bank)
        return self._isas[key]

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
        """Per-bank simulated command time (sum over that bank's sims)."""
        out = [0.0] * self.banks
        for (b, *_), isa in self._isas.items():
            out[b] += isa.sim.log.time_ns
        return out

    def makespan_ns(self) -> float:
        """Optimistic modeled array time: banks run concurrently, so the
        array finishes with its slowest bank (no tRRD/tFAW arbitration,
        no refresh)."""
        return max(self.bank_time_ns())

    def total_time_ns(self) -> float:
        """Sum of per-bank times — what one bank would have taken."""
        return float(sum(self.bank_time_ns()))
