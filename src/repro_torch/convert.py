"""Carry chip state across from the reference simulator.

The system holds no weights; what it carries is the state of a simulated
bank.  :func:`numpy_bank_state` reads the plain numpy/int state of a
reference ``repro.core.simulator.BankSim`` (by attribute, without importing
the reference), and :func:`bank_state_from_numpy` rebuilds it as a port
:class:`~repro_torch.core.simulator.BankSim` on a device — so one episode
can be forked into both packages mid-stream and continued in each.

The PuD engine holds no state to carry: a packed bit-plane of the reference
(uint32 words) crosses over as
``torch.from_numpy(np.asarray(p).view(np.int32))`` — the port's planes are
int32 bit patterns (``repro_torch.pud.engine.as_planes`` does this).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.analog import AnalogParams
from .core.simulator import BankSim

#: constructor settings of the bank, then its mutable state
SETTINGS = ("module", "row_bits", "trials", "error_model", "temp_c",
            "track_unshared", "rowclone_fail_p", "seed", "noise_seed",
            "bank", "params")
STATE = ("_subarrays", "_rowmap", "_nrows", "_static", "_trial")


def numpy_bank_state(sim) -> dict:
    """The plain state of a reference-style bank simulator: settings as
    Python values (``module`` by name, ``params`` as a dict), cell buffers,
    slot maps, static latents and the command counter as numpy/ints."""
    state = {k: getattr(sim, k) for k in SETTINGS + STATE
             if k not in ("module", "row_bits", "params")}
    state["module"] = sim.module.name
    state["row_bits"] = sim.geom.row_bits
    state["params"] = dataclasses.asdict(sim.params)
    return state


def bank_state_from_numpy(state: dict, device: str | torch.device, *,
                          draws: str = "numpy") -> BankSim:
    """A port ``BankSim`` on ``device`` holding ``state`` (as produced by
    :func:`numpy_bank_state`); ``draws="numpy"`` continues the reference's
    per-command noise streams draw for draw."""
    missing = [k for k in SETTINGS + STATE if k not in state]
    if missing:
        raise KeyError(f"bank state lacks {missing}")
    sim = BankSim(state["module"], row_bits=state["row_bits"],
                  seed=state["seed"], params=AnalogParams(**state["params"]),
                  temp_c=state["temp_c"], error_model=state["error_model"],
                  trials=state["trials"],
                  track_unshared=state["track_unshared"],
                  noise_seed=state["noise_seed"],
                  rowclone_fail_p=state["rowclone_fail_p"],
                  bank=state["bank"], draws=draws, device=device)
    sim._subarrays = {int(s): torch.from_numpy(np.array(a, np.float32))
                      .to(sim.device)
                      for s, a in state["_subarrays"].items()}
    sim._rowmap = {int(s): np.array(m, np.int64)
                   for s, m in state["_rowmap"].items()}
    sim._nrows = {int(s): int(n) for s, n in state["_nrows"].items()}
    sim._static = {int(s): (np.array(a), np.array(b))
                   for s, (a, b) in state["_static"].items()}
    sim._trial = int(state["_trial"])
    return sim
