"""Engine-facing configuration types: ResidentPolicy + EngineConfig.

The port's copy of ``repro.core.policy``:

* :class:`ResidentPolicy` — a ``str``-subclass enum (``HOST`` /
  ``GREEDY`` / ``SCHEDULED``): how compiled programs execute on the DRAM
  backend.  Members *are* strings, so they compare equal to the plain
  spellings.
* :class:`EngineConfig` — a frozen dataclass holding the whole engine
  configuration (backend, module, noise, seed, resident policy, block
  chaining, bank count, fusion, plan verification);
  ``PudEngine(EngineConfig(...))`` is the same as the individual kwargs.

Legacy spellings (``resident=True/False/"greedy"/"scheduled"`` as plain
bool/str) coerce through :func:`coerce_resident`, which emits a
:class:`DeprecationWarning` **once per call site** and maps them onto the
enum; enum members never warn.

The one difference from the reference: the backends are the port's
(``"torch"``, ``"kernel"``, ``"dram"``; default ``"kernel"``).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from enum import Enum

__all__ = ["ResidentPolicy", "EngineConfig", "coerce_resident",
           "reset_deprecation_warnings"]


class ResidentPolicy(str, Enum):
    """How compiled programs execute on the DRAM backend.

    ``HOST`` — host-staged reference path: every instruction's operands
    cross the DDR bus (was ``resident=False``).
    ``GREEDY`` — the bit-for-bit resident reference executor.
    ``SCHEDULED`` — the compile-time polarity/residency scheduler (the
    engine default on the dram backend; was ``resident=True``).
    """

    HOST = "host"
    GREEDY = "greedy"
    SCHEDULED = "scheduled"

    @property
    def is_resident(self) -> bool:
        return self is not ResidentPolicy.HOST

    def to_legacy(self) -> bool | str:
        """The internal tri-state the executors consume
        (``False`` | ``"greedy"`` | ``"scheduled"``)."""
        return False if self is ResidentPolicy.HOST else self.value


#: call sites that already emitted their one deprecation warning
_WARNED: set[str] = set()


def reset_deprecation_warnings() -> None:
    """Forget which call sites warned (tests of the warn-once shim)."""
    _WARNED.clear()


def coerce_resident(value, *, where: str,
                    default: ResidentPolicy = ResidentPolicy.HOST
                    ) -> ResidentPolicy:
    """Map any accepted ``resident=`` spelling onto a ResidentPolicy.

    ``None`` means "unset" and resolves to ``default`` silently.  Enum
    members pass through silently.  Legacy plain ``bool``/``str``
    spellings are coerced (``True`` -> SCHEDULED, ``False`` -> HOST,
    ``"greedy"``/``"scheduled"``/``"host"`` by value) with one
    DeprecationWarning per ``where`` call-site key.
    """
    if value is None:
        return default
    if isinstance(value, ResidentPolicy):
        return value
    if isinstance(value, bool):
        pol = ResidentPolicy.SCHEDULED if value else ResidentPolicy.HOST
    elif isinstance(value, str):
        try:
            pol = ResidentPolicy(value)
        except ValueError:
            raise ValueError(
                f"unknown resident mode {value!r} (want a ResidentPolicy, "
                f"True/False, or one of "
                f"{[p.value for p in ResidentPolicy]})") from None
    else:
        raise ValueError(f"unknown resident mode {value!r}")
    if where not in _WARNED:
        _WARNED.add(where)
        warnings.warn(
            f"{where}: resident={value!r} (plain bool/str) is deprecated; "
            f"pass ResidentPolicy.{pol.name} instead",
            DeprecationWarning, stacklevel=3)
    return pol


@dataclass(frozen=True)
class EngineConfig:
    """Frozen configuration of a :class:`~repro_torch.pud.engine.PudEngine`.

    ``resident=None`` defers to the backend default (SCHEDULED on
    ``dram``, HOST elsewhere) — resolved by :meth:`resolved_resident`.
    ``banks`` > 1 deals dram-backend work round-robin across a
    :class:`~repro_torch.core.bankarray.BankArray` of independent per-bank
    chips (the other backends have no banks).  ``fused`` is the multi-bank
    fused-execution tri-state of the reference (``None`` auto, ``False``
    per-bank loop, ``True`` forced).  ``verify`` is the static
    plan-verification tri-state: ``True`` verifies every resident plan the
    engine schedules (:func:`repro_torch.analysis.verify_plan`), ``False``
    never does, and ``None`` (the default) defers to
    :func:`repro_torch.analysis.default_verify` — on under pytest/debug,
    off elsewhere — resolved by :meth:`resolved_verify`.
    """

    backend: str = "kernel"
    module: str | None = None
    noisy: bool = False
    seed: int = 0
    resident: ResidentPolicy | None = None
    chain_blocks: bool = True
    banks: int = 1
    fused: bool | None = None
    verify: bool | None = None

    def __post_init__(self):
        if self.banks < 1:
            raise ValueError(f"banks must be >= 1, got {self.banks}")
        if self.fused is not None and not isinstance(self.fused, bool):
            raise TypeError(
                f"EngineConfig.fused wants True/False/None, "
                f"got {self.fused!r}")
        if self.verify is not None and not isinstance(self.verify, bool):
            raise TypeError(
                f"EngineConfig.verify wants True/False/None, "
                f"got {self.verify!r}")
        if self.resident is not None \
                and not isinstance(self.resident, ResidentPolicy):
            raise TypeError(
                f"EngineConfig.resident wants a ResidentPolicy or None, "
                f"got {self.resident!r}")

    def resolved_resident(self) -> ResidentPolicy:
        if self.resident is not None:
            return self.resident
        return (ResidentPolicy.SCHEDULED if self.backend == "dram"
                else ResidentPolicy.HOST)

    def resolved_verify(self) -> bool:
        """The effective plan-verification switch (see ``verify``)."""
        if self.verify is not None:
            return self.verify
        from .. import analysis
        return analysis.default_verify()

    def with_(self, **changes) -> "EngineConfig":
        """A copy with the given fields replaced (frozen-friendly)."""
        return replace(self, **changes)
