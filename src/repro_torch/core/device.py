"""DRAM device model for the FCDRAM substrate.

Models the hardware context of the paper:
  - DDR4 command timings per speed grade (used by the cost model and the
    reduced-timing ``ACT -> PRE -> ACT`` (APA) sequences),
  - open-bitline bank/subarray geometry (neighboring subarrays share half of
    their sense amplifiers; footnote 6 of the paper: inter-subarray operations
    act on *half* of a row),
  - the module zoo of Table 1 (manufacturer, die revision, density, speed) with
    per-module capability flags (SK Hynix: simultaneous multi-row activation in
    neighboring subarrays; Samsung: sequential two-row only -> NOT only;
    Micron: neither -> no bitwise ops), and
  - per-module analog modifiers (speed-grade, die-revision) feeding the
    calibrated reliability model in ``repro.core.analog``.

Everything here is plain-Python configuration: no jax device state is touched.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field


class Manufacturer(enum.Enum):
    SK_HYNIX = "sk_hynix"
    SAMSUNG = "samsung"
    MICRON = "micron"


class ActivationSupport(enum.Enum):
    """Multi-row activation capability in *neighboring* subarrays (§4.3, §7)."""

    SIMULTANEOUS = "simultaneous"  # SK Hynix: N:N and N:2N up to 16:32
    SEQUENTIAL = "sequential"      # Samsung: two-row sequential only (NOT w/ 1 dst)
    NONE = "none"                  # Micron: command ignored under gross violation


@dataclass(frozen=True)
class DRAMTimings:
    """DDR4 timing parameters in nanoseconds for one speed grade."""

    speed_mts: int
    tCK: float      # clock period
    tRCD: float     # ACT -> RD/WR
    tRAS: float     # ACT -> PRE
    tRP: float      # PRE -> ACT
    tCL: float      # CAS latency
    tWR: float      # write recovery
    tRFC: float     # refresh cycle (8Gb-class)
    tREFI: float    # refresh interval
    tRRD: float = 4.9   # ACT -> ACT, different rows of one bank group
    tFAW: float = 21.0  # four-activate window (rolling, per rank)

    @property
    def tRC(self) -> float:
        return self.tRAS + self.tRP

    def violated(self, *, tras_ns: float, trp_ns: float) -> "DRAMTimings":
        """A copy with reduced (violated) tRAS / tRP, as used by APA sequences."""
        return dataclasses.replace(self, tRAS=tras_ns, tRP=trp_ns)


# JEDEC-derived nominal grades (DDR4).  The paper tests 2133 / 2400 / 2666 /
# 3200 MT/s modules; values below are standard -U/-V bin timings.
TIMINGS: dict[int, DRAMTimings] = {
    2133: DRAMTimings(2133, 0.937, 14.06, 33.0, 14.06, 14.06, 15.0, 350.0, 7800.0,
                      tRRD=5.3, tFAW=21.0),
    2400: DRAMTimings(2400, 0.833, 13.32, 32.0, 13.32, 13.32, 15.0, 350.0, 7800.0,
                      tRRD=4.9, tFAW=21.0),
    2666: DRAMTimings(2666, 0.750, 13.50, 32.0, 13.50, 13.50, 15.0, 350.0, 7800.0,
                      tRRD=4.9, tFAW=21.0),
    3200: DRAMTimings(3200, 0.625, 13.75, 32.0, 13.75, 13.75, 15.0, 350.0, 7800.0,
                      tRRD=4.9, tFAW=21.0),
}

#: Reduced timings used for multi-row activation (paper: "e.g., tRP < 3ns").
VIOLATED_TRP_NS = 1.5
VIOLATED_TRAS_NS = 1.5


@dataclass(frozen=True)
class SubarrayGeometry:
    """Open-bitline subarray geometry.

    ``row_bits`` is the per-chip row width in bits (x8 DDR4: 8192 bits = 1KB
    per chip; a rank of 8 chips exposes an 8KB row).  In the open-bitline
    architecture every other bitline terminates in the sense-amplifier stripe
    shared with the upper neighbor, the rest with the lower neighbor, so
    inter-subarray (NOT / NAND / NOR / AND / OR) operations compute on
    ``row_bits // 2`` positions (stride-2 layout).
    """

    subarrays_per_bank: int = 64
    rows_per_subarray: int = 512
    row_bits: int = 8192

    @property
    def shared_bits(self) -> int:
        return self.row_bits // 2

    def distance_region(self, row_in_subarray: int, *, toward_upper: bool) -> int:
        """Design-induced-variation region of a row w.r.t. a shared SA stripe.

        Returns 0 = Close, 1 = Middle, 2 = Far (§5.2 "Distance Between a Row
        and Sense Amplifiers"; thirds of the subarray).  ``toward_upper``
        selects which of the two SA stripes the operation uses.
        """
        n = self.rows_per_subarray
        pos = row_in_subarray if toward_upper else (n - 1 - row_in_subarray)
        third = n // 3
        if pos < third:
            return 0
        if pos < 2 * third:
            return 1
        return 2

    def distance_regions(self, rows, *, toward_upper: bool):
        """Vectorized :meth:`distance_region` over an array of rows."""
        import numpy as np
        n = self.rows_per_subarray
        rows = np.asarray(rows)
        pos = rows if toward_upper else (n - 1 - rows)
        return np.minimum(pos // (n // 3), 2).astype(np.int64)


REGION_NAMES = ("close", "middle", "far")


@dataclass(frozen=True)
class ModuleConfig:
    """One DRAM module family from Table 1 of the paper."""

    name: str
    manufacturer: Manufacturer
    die_rev: str
    density_gb: int              # per-chip density in Gbit
    org: str                     # "x4" / "x8"
    speed_mts: int
    n_modules: int = 1
    n_chips: int = 8
    activation: ActivationSupport = ActivationSupport.SIMULTANEOUS
    #: maximum simultaneously-activated rows across the two subarrays
    max_simultaneous_rows: int = 48      # 16:32 (N:2N with N=16)
    supports_n2n: bool = True            # some modules are N:N-only (max 32)
    geometry: SubarrayGeometry = field(default_factory=SubarrayGeometry)
    banks: int = 16

    @property
    def max_inputs(self) -> int:
        """Maximum Boolean-op fan-in (N:N activation with N rows per side)."""
        if self.activation is not ActivationSupport.SIMULTANEOUS:
            return 0
        return min(16, self.max_simultaneous_rows // 2)

    @property
    def supports_not(self) -> bool:
        return self.activation in (
            ActivationSupport.SIMULTANEOUS,
            ActivationSupport.SEQUENTIAL,
        )


def _m(name, mfr, die, dens, org, speed, n_mod, n_chips, act, max_rows=48, n2n=True):
    return ModuleConfig(
        name=name, manufacturer=mfr, die_rev=die, density_gb=dens, org=org,
        speed_mts=speed, n_modules=n_mod, n_chips=n_chips, activation=act,
        max_simultaneous_rows=max_rows, supports_n2n=n2n,
    )


#: Table 1 of the paper (+ the non-operational Micron family from §3.2/§7).
MODULE_ZOO: dict[str, ModuleConfig] = {
    m.name: m
    for m in [
        _m("hynix_4gb_m_2666", Manufacturer.SK_HYNIX, "M", 4, "x8", 2666, 9, 72,
           ActivationSupport.SIMULTANEOUS),
        _m("hynix_4gb_a_2133", Manufacturer.SK_HYNIX, "A", 4, "x8", 2133, 5, 40,
           ActivationSupport.SIMULTANEOUS),
        _m("hynix_8gb_a_2666", Manufacturer.SK_HYNIX, "A", 8, "x8", 2666, 1, 16,
           ActivationSupport.SIMULTANEOUS),
        _m("hynix_4gb_a_2400", Manufacturer.SK_HYNIX, "A", 4, "x4", 2400, 1, 32,
           ActivationSupport.SIMULTANEOUS),
        _m("hynix_8gb_a_2400", Manufacturer.SK_HYNIX, "A", 8, "x4", 2400, 1, 32,
           ActivationSupport.SIMULTANEOUS),
        # 8Gb M-die supports only up to 8:8 (footnote 12) -> 16 rows, N:N only.
        _m("hynix_8gb_m_2666", Manufacturer.SK_HYNIX, "M", 8, "x4", 2666, 1, 32,
           ActivationSupport.SIMULTANEOUS, max_rows=16, n2n=False),
        _m("samsung_4gb_f_2666", Manufacturer.SAMSUNG, "F", 4, "x8", 2666, 1, 8,
           ActivationSupport.SEQUENTIAL, max_rows=2, n2n=False),
        _m("samsung_8gb_d_2133", Manufacturer.SAMSUNG, "D", 8, "x8", 2133, 2, 16,
           ActivationSupport.SEQUENTIAL, max_rows=2, n2n=False),
        _m("samsung_8gb_a_3200", Manufacturer.SAMSUNG, "A", 8, "x8", 3200, 1, 8,
           ActivationSupport.SEQUENTIAL, max_rows=2, n2n=False),
        _m("micron_8gb_b_3200", Manufacturer.MICRON, "B", 8, "x8", 3200, 2, 16,
           ActivationSupport.NONE, max_rows=1, n2n=False),
    ]
}

DEFAULT_MODULE = "hynix_4gb_m_2666"


def get_module(name: str = DEFAULT_MODULE) -> ModuleConfig:
    try:
        return MODULE_ZOO[name]
    except KeyError as e:
        raise KeyError(
            f"unknown module {name!r}; known: {sorted(MODULE_ZOO)}") from e


def timings_for(module: ModuleConfig) -> DRAMTimings:
    return TIMINGS[module.speed_mts]


# ---------------------------------------------------------------------------
# Energy model (pJ) — used by the offload cost model.  Constants follow the
# standard DDR4 power literature (Ghose+ SIGMETRICS'18 measurements order):
# row activation ~ 1-2 nJ/bank-row; IO transfer dominates off-chip movement.
# ---------------------------------------------------------------------------
ENERGY_PJ = {
    "act": 1700.0,          # one ACT (whole row, per chip)
    "pre": 700.0,
    "rd_per_64B": 2100.0,   # on-die read burst
    "wr_per_64B": 2300.0,
    "io_per_64B": 10400.0,  # off-chip bus transfer (the movement PuD avoids)
    "cpu_op_per_64B": 3200.0,  # ALU pass over 64B incl. cache hierarchy
}
