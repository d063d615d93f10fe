"""Calibrated analog reliability model for in-DRAM Boolean operations.

This is the quantitative heart of the FCDRAM reproduction: a closed-form model
of the charge-sharing + sense-amplification process of §5/§6 of the paper,
whose free constants are fitted (``repro.core.calibrate``) against the paper's
measured success-rate statistics (Figs. 7-21, Obs. 3-19).

Physical model
--------------
Charge sharing: activating ``N`` cells on a bitline with capacitance ratio
``r = C_bitline / C_cell`` moves the bitline from VDD/2 by ``+u_N/2`` per
logic-1 cell and ``-u_N/2`` per logic-0 cell, with ``u_N = VDD / (r + N)``
(a Frac cell contributes 0).  For an N-input AND the reference subarray holds
N-1 logic-1 rows + one Frac row, so

    V_REF(AND) - VDD/2 = +u_N (N-1)/2 ,   V_REF(OR) - VDD/2 = -u_N (N-1)/2
    V_COM      - VDD/2 =  u_N (k - N/2)          (k = #logic-1 operands)

and the sense amplifier outputs ``V_COM > V_REF``.  Nominal decision margins
are therefore ``u_N (k - N + 1/2)`` (AND) and ``u_N (k - 1/2)`` (OR): the
boundary input patterns sit half a cell-charge from the decision threshold,
exactly the paper's construction (§6.1.2).

Sense decision — per-cell static offset mixture
-----------------------------------------------
The paper's box plots (Figs. 7/15) show *bimodal cell populations*: for
boundary input patterns many cells succeed ~always and many fail ~always
(Obs. 3: some cells are 100%; Obs. 14: boundary patterns average near coin
flip).  A single Gaussian noise term cannot produce a ~50% average at margin
±u/2 *and* ~99% at 1.5u.  We therefore model each (cell, sense-amp) pair with
a *static* comparator offset ``O`` drawn from a three-component mixture

    O  ~  (1-2w) N(0, s)  +  w N(-b, s)  +  w N(+b, s)

(process-variation "spike" at ±b volts: imbalanced SA inverter pairs), plus a
margin-independent activation-failure floor ``pf`` (a failed multi-row
activation yields a coin flip; Fig. 5 coverage << 100%).  The probability the
comparator resolves to logic-1 at margin ``m`` volts is

    P1(m) = F((m - delta)) ,
    F(x)  = (1-2w) Phi(x/s) + w Phi((x-b)/s) + w Phi((x+b)/s)

and the per-cell-averaged success rate of an operation with ideal output
``o`` is ``pf/2 + (1-pf) * (o ? P1 : 1-P1)``.

Modifiers (each maps to a paper observation):

* **Common-mode asymmetry**: sensing degrades at high common-mode voltage
  (AND biases bitlines toward VDD, OR toward GND) => OR/NOR beat AND/NAND at
  small N (Obs. 12); implemented as ``exp(c * CM)`` scalings of s, b, pf.
* **Reference-side penalty**: NAND/NOR (read from the reference subarray)
  see slightly wider s => NAND/NOR trail AND/OR at small N, converge at 16
  (Obs. 13).
* **Data pattern**: random row contents add bitline-coupling noise
  (sigma_dp) and raise the floor (Obs. 16); all-1s/0s rows do not.
* **Temperature**: scales s and pf mildly (Obs. 7/17).
* **Speed grade**: per-grade s multiplier (non-monotonic in MT/s, Obs. 8/18).
* **Die revision / density**: additive margin offset per module family
  (Obs. 9/19).
* **Design-induced distance variation**: additive margin offsets per
  (row region -> shared-SA distance) pair (Obs. 6/15), damped per op family.

NOT (§5) is modeled separately: after the source row is restored, the shared
sense amplifiers must drive ``T = N_RF + N_RL`` simultaneously activated rows;
the drive margin shrinks linearly in T (Obs. 4), which also yields the N:2N >
N:N advantage (Obs. 5: at equal destination count, N:2N drives 1.5x fewer
total rows than N:N).

All functions are pure numpy (the jax twin used by the Pallas sense-amp kernel
lives in ``repro.kernels.senseamp.ref`` and is tested against this oracle).
Fitted constants: see ``repro.core.calibrate`` and EXPERIMENTS.md
§Calibration for the fit residuals against every quantified paper claim.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np

VDD = 1.0

_erf = np.frompyfunc(math.erf, 1, 1)


def phi(z):
    """Standard normal CDF, elementwise, numpy-native."""
    z = np.asarray(z, dtype=np.float64)
    return 0.5 * (1.0 + np.asarray(_erf(z / math.sqrt(2.0)), dtype=np.float64))


# Ops on the compute side and their reference-side (inverted) twins.
COMPUTE_OPS = ("and", "or")
REFERENCE_OPS = ("nand", "nor")
ALL_OPS = COMPUTE_OPS + REFERENCE_OPS

#: region codes (see device.SubarrayGeometry.distance_region)
CLOSE, MIDDLE, FAR = 0, 1, 2


@dataclass(frozen=True)
class AnalogParams:
    """Fitted constants (see ``repro.core.calibrate.fit``)."""

    # --- charge sharing ---
    r_blcap: float = 6.0          # C_bitline / C_cell
    # --- comparator offset mixture ---
    sigma_sa: float = 0.0046003        # central component sd [V]
    eta_cell: float = 0.029612        # per-cell charge noise, in units of u_N
    b_u: float = 1.75117              # static offset spike magnitude, units of u_N
    # spike weight: w = 0.5*sigmoid(w_a*ln n + w_b + w_c*family_sign)
    w_a: float = 2.10037
    w_b: float = -4.21799
    w_c: float = 0.208423
    # spike skew: the spike leans toward the high-common-mode side
    # (w+ = w*(1+skew*sign), w- = w*(1-skew*sign)); lets boundary-pattern
    # success fall below 50% (Fig. 16's deep dips).
    w_skew: float = 0.604254
    # Frac-row drift toward the reference constant rows (coupling, §6.3):
    # shifts the decision threshold by +f*u_N for AND-family, -f*u_N for OR.
    frac_drift: float = 0.425763
    delta_v: float = 0.0          # global systematic threshold shift [V]
    # --- activation-failure floor ---
    pf_a: float = 0.0042215
    pf_b: float = 0.722803
    c_pf_cm: float = 0.476329         # family asymmetry of the floor
    # --- reference-side (NAND/NOR) penalty ---
    ref_sig: float = 0.0175914         # fractional sigma widening
    # --- data pattern (random vs all-1s/0s) ---
    sigma_dp: float = 0.0075321        # extra coupling noise, random rows [V]
    dp_pf: float = 0.537118            # fractional floor increase, random rows
    dp_cm: float = -0.392083            # family dependence of the pattern effect
    # --- temperature (per degC above 50) ---
    temp_sig: float = 0.0027459       # fractional sigma growth / degC
    temp_pf: float = 0.0138937       # fractional floor growth / degC
    # --- speed grade: sigma multipliers (ops) ---
    speed_sigma: tuple = ((2133, 0.61092), (2400, 4.00454), (2666, 1.0), (3200, 0.24599))
    # --- speed grade: activation-floor multipliers (ops) ---
    speed_pf: tuple = ((2133, 0.24458), (2400, 24.5048), (2666, 1.0), (3200, 0.59361))
    # --- die revision / density: sigma multipliers (ops) ---
    die_sig: tuple = (
        (("sk_hynix", 4, "A"), 1.0),
        (("sk_hynix", 4, "M"), 1.63785),
        (("sk_hynix", 8, "A"), 6.00313),
        (("sk_hynix", 8, "M"), 5.61396),
    )
    # --- design-induced variation: margin offsets [V] per region C/M/F ---
    dist_com: tuple = (-0.000894, 0.0, 0.056424)       # compute-row region
    dist_ref: tuple = (-0.058861, 0.0, -0.007911)       # reference-row region
    op_dist_scale_and: float = 2.09989              # damping per op family
    op_dist_scale_or: float = 1.66932
    # --- die revision / density: margin offsets [V] ---
    die_dv: tuple = (
        (("sk_hynix", 4, "A"), 0.0),
        (("sk_hynix", 4, "M"), -0.059470),
        (("sk_hynix", 8, "A"), 0.070779),
        (("sk_hynix", 8, "M"), -0.003394),
    )
    # =====================  NOT operation  =====================
    not_z0: float = 5.03222         # drive margin at T=2 rows, in z units
    not_beta: float = 0.165281      # margin loss per extra driven row
    not_pf0: float = 0.0101626       # activation floor at T=2
    not_pf_slope: float = 0.0026881  # floor growth per extra row
    not_temp_z: float = 0.00006   # NOT is nearly temperature-flat (Obs. 7)
    # speed multiplies z (V-shaped in MT/s, Obs. 8)
    not_speed_z: tuple = ((2133, 1.01319), (2400, 0.60506), (2666, 1.0), (3200, 0.67328))
    # distance z offsets per region C/M/F (src row, dst rows)
    not_dist_src: tuple = (-1.42174, 0.0, -2.50518)
    not_dist_dst: tuple = (-1.49787, 0.0, 1.39083)
    # die z offsets
    not_die_dz: tuple = (
        (("sk_hynix", 4, "A"), 0.0),
        (("sk_hynix", 4, "M"), -0.45821),
        (("sk_hynix", 8, "A"), -1.23202),
        (("sk_hynix", 8, "M"), -0.05664),
        (("samsung", 4, "F"), 1.48920),
        (("samsung", 8, "A"), 1.96393),
        (("samsung", 8, "D"), -1.32102),
    )

    def speed_mult(self, speed_mts: int) -> float:
        for s, m in self.speed_sigma:
            if s == speed_mts:
                return m
        return 1.0

    def speed_pf_mult(self, speed_mts: int) -> float:
        for s, m in self.speed_pf:
            if s == speed_mts:
                return m
        return 1.0

    def die_sig_mult(self, mfr: str, density_gb: int, die_rev: str) -> float:
        for (m, d, r), v in self.die_sig:
            if (m, d, r) == (mfr, density_gb, die_rev):
                return v
        return 1.0

    def not_speed_mult(self, speed_mts: int) -> float:
        for s, m in self.not_speed_z:
            if s == speed_mts:
                return m
        return 1.0

    def die_offset(self, mfr: str, density_gb: int, die_rev: str) -> float:
        for (m, d, r), dv in self.die_dv:
            if (m, d, r) == (mfr, density_gb, die_rev):
                return dv
        return 0.0

    def not_die_offset(self, mfr: str, density_gb: int, die_rev: str) -> float:
        for (m, d, r), dz in self.not_die_dz:
            if (m, d, r) == (mfr, density_gb, die_rev):
                return dz
        return 0.0

    def replace(self, **kw) -> "AnalogParams":
        return dataclasses.replace(self, **kw)


DEFAULT_PARAMS = AnalogParams()


def u_n(n: int, p: AnalogParams = DEFAULT_PARAMS) -> float:
    """Per-cell charge-share swing [V] with N cells on the bitline."""
    return VDD / (p.r_blcap + n)


# ---------------------------------------------------------------------------
# Boolean (AND/OR/NAND/NOR) success model
# ---------------------------------------------------------------------------
def _base_op(op: str) -> tuple[str, bool]:
    """-> (compute-side op, is_reference_side)."""
    op = op.lower()
    if op in ("and", "nand"):
        return "and", op == "nand"
    if op in ("or", "nor"):
        return "or", op == "nor"
    raise ValueError(f"unknown op {op!r}")


def op_margin(op: str, n: int, k, p: AnalogParams = DEFAULT_PARAMS):
    """Nominal margin V_COM - V_REF in volts for k logic-1 operands."""
    base, _ = _base_op(op)
    k = np.asarray(k, dtype=np.float64)
    u = u_n(n, p)
    if base == "and":
        return u * (k - n + 0.5)
    return u * (k - 0.5)


def op_ideal(op: str, n: int, k):
    """Ideal Boolean output for k logic-1 operands (bool array)."""
    base, is_ref = _base_op(op)
    k = np.asarray(k)
    out = (k == n) if base == "and" else (k > 0)
    return np.logical_xor(out, is_ref)


def _cm_signed(op: str, n: int, p: AnalogParams) -> float:
    """Signed common-mode deviation: +(N-1)u_N/2 for AND-family, - for OR."""
    base, _ = _base_op(op)
    cm = u_n(n, p) * (n - 1) / (2.0 * VDD)
    return cm if base == "and" else -cm


def mixture_cdf(x, s: float, b: float, w_plus: float, w_minus: float):
    """P(margin + static offset + noise > 0) at margin x: the comparator's
    probability of resolving logic-1.  Spike components at +/- b volts with
    (possibly skewed) weights."""
    x = np.asarray(x, dtype=np.float64)
    return ((1.0 - w_plus - w_minus) * phi(x / s)
            + w_plus * phi((x + b) / s)
            + w_minus * phi((x - b) / s))


def _sigmoid(x: float) -> float:
    if x >= 0:
        return 1.0 / (1.0 + math.exp(-x))
    e = math.exp(x)
    return e / (1.0 + e)


def _family_sign(op: str) -> float:
    return 1.0 if _base_op(op)[0] == "and" else -1.0


def op_noise(op: str, n: int, p: AnalogParams = DEFAULT_PARAMS, *,
             temp_c: float = 50.0, random_pattern: bool = True,
             speed_mts: int = 2666, mfr: str = "sk_hynix",
             density_gb: int = 4, die_rev: str = "A",
             ) -> tuple[float, float, float, float]:
    """-> (s, b, w_plus, w_minus) of the offset mixture for this context."""
    u = u_n(n, p)
    sgn = _family_sign(op)
    s = math.sqrt(p.sigma_sa ** 2 + (p.eta_cell * u) ** 2)
    s *= p.speed_mult(speed_mts)
    s *= p.die_sig_mult(mfr, density_gb, die_rev)
    if random_pattern:
        s = math.sqrt(s ** 2 + p.sigma_dp ** 2)
    s *= 1.0 + p.temp_sig * max(temp_c - 50.0, 0.0)
    _, is_ref = _base_op(op)
    if is_ref:
        s *= 1.0 + p.ref_sig
    b = p.b_u * u
    w = 0.5 * _sigmoid(p.w_a * math.log(n) + p.w_b + p.w_c * sgn)
    skew = max(min(p.w_skew * sgn, 0.9), -0.9)
    w_plus = min(w * (1.0 + skew), 0.95)
    w_minus = max(min(w * (1.0 - skew), 0.95), 0.0)
    if w_plus + w_minus > 0.98:
        scale = 0.98 / (w_plus + w_minus)
        w_plus *= scale
        w_minus *= scale
    return s, b, w_plus, w_minus


def op_shift(op: str, n: int, p: AnalogParams = DEFAULT_PARAMS) -> float:
    """Decision-threshold shift [V]: the Frac reference row drifts toward the
    value of the N-1 constant rows sharing its bitline (coupling, cf. the
    paper's §6.3 hypothesis).  AND-family: threshold rises (all-ones input
    patterns suffer, Obs. 14); OR-family: threshold falls (all-zeros suffer).
    The margin is *reduced* by this amount before the comparator."""
    return p.frac_drift * u_n(n, p) * _family_sign(op)


def op_pfloor(op: str, n: int, p: AnalogParams = DEFAULT_PARAMS, *,
              temp_c: float = 50.0, random_pattern: bool = True,
              speed_mts: int = 2666) -> float:
    """Margin-independent activation-failure floor probability."""
    cm = _cm_signed(op, n, p)
    pf = p.pf_a * (2.0 * n) ** p.pf_b
    pf *= math.exp(p.c_pf_cm * cm)
    pf *= p.speed_pf_mult(speed_mts)
    if random_pattern:
        pf *= 1.0 + p.dp_pf * math.exp(p.dp_cm * cm)
    pf *= 1.0 + p.temp_pf * max(temp_c - 50.0, 0.0)
    return float(np.clip(pf, 0.0, 0.75))


def margin_offset(op: str, p: AnalogParams = DEFAULT_PARAMS, *,
                  compute_region: int = MIDDLE, ref_region: int = MIDDLE,
                  mfr: str = "sk_hynix", density_gb: int = 4,
                  die_rev: str = "A") -> float:
    """Additive margin offset [V]: distance + die-revision effects."""
    base, _ = _base_op(op)
    scale = p.op_dist_scale_and if base == "and" else p.op_dist_scale_or
    dv = scale * (p.dist_com[compute_region] + p.dist_ref[ref_region])
    dv += p.die_offset(mfr, density_gb, die_rev)
    return dv


def comparator_p1(margin_v, op: str, n: int, *,
                  p: AnalogParams = DEFAULT_PARAMS, temp_c: float = 50.0,
                  random_pattern: bool = True, speed_mts: int = 2666,
                  compute_region: int = MIDDLE, ref_region: int = MIDDLE,
                  mfr: str = "sk_hynix", density_gb: int = 4,
                  die_rev: str = "A"):
    """P(sense amp resolves logic-1) at raw margin V_COM - V_REF (volts).

    This is the primitive the Monte-Carlo simulator uses for arbitrary cell
    voltages (e.g. Frac rows, partially-restored rows).
    """
    s, b, wp, wm = op_noise(op, n, p, temp_c=temp_c,
                            random_pattern=random_pattern,
                            speed_mts=speed_mts, mfr=mfr,
                            density_gb=density_gb, die_rev=die_rev)
    dv = margin_offset(op, p, compute_region=compute_region,
                       ref_region=ref_region, mfr=mfr, density_gb=density_gb,
                       die_rev=die_rev)
    shift = op_shift(op, n, p)
    return mixture_cdf(np.asarray(margin_v) + dv - shift - p.delta_v,
                       s, b, wp, wm)


def boolean_success(op: str, n: int, k, *, p: AnalogParams = DEFAULT_PARAMS,
                    temp_c: float = 50.0, random_pattern: bool = True,
                    speed_mts: int = 2666,
                    compute_region: int = MIDDLE, ref_region: int = MIDDLE,
                    mfr: str = "sk_hynix", density_gb: int = 4,
                    die_rev: str = "A") -> np.ndarray:
    """P(cell stores the correct op result) for ``k`` logic-1 operands.

    ``k`` may be an array; the result is elementwise and averaged over the
    cell population (static offsets integrated out).
    """
    m = op_margin(op, n, k, p)
    p1 = comparator_p1(m, op, n, p=p, temp_c=temp_c,
                       random_pattern=random_pattern, speed_mts=speed_mts,
                       compute_region=compute_region, ref_region=ref_region,
                       mfr=mfr, density_gb=density_gb, die_rev=die_rev)
    ideal_compute = op_ideal("and" if _base_op(op)[0] == "and" else "or", n, k)
    s_analog = np.where(ideal_compute, p1, 1.0 - p1)
    pf = op_pfloor(op, n, p, temp_c=temp_c, random_pattern=random_pattern,
                   speed_mts=speed_mts)
    return (1.0 - pf) * s_analog + 0.5 * pf


def margin_offset_grid(op: str, p: AnalogParams = DEFAULT_PARAMS, *,
                       mfr: str = "sk_hynix", density_gb: int = 4,
                       die_rev: str = "A") -> np.ndarray:
    """(3, 3) additive margin offsets over (compute_region, ref_region)."""
    base, _ = _base_op(op)
    scale = p.op_dist_scale_and if base == "and" else p.op_dist_scale_or
    com = np.asarray(p.dist_com, dtype=np.float64)
    ref = np.asarray(p.dist_ref, dtype=np.float64)
    return scale * (com[:, None] + ref[None, :]) \
        + p.die_offset(mfr, density_gb, die_rev)


def boolean_success_grid(op: str, n: int, k=None, *,
                         p: AnalogParams = DEFAULT_PARAMS,
                         temp_c: float = 50.0, random_pattern: bool = True,
                         speed_mts: int = 2666, mfr: str = "sk_hynix",
                         density_gb: int = 4, die_rev: str = "A") -> np.ndarray:
    """``boolean_success`` over the full 3x3 distance-region grid in one
    vectorized evaluation: (3, 3, len(k)) for (compute_region, ref_region, k).

    Identical math to calling :func:`boolean_success` per region pair (the
    region only enters through the additive margin offset), ~9x fewer passes.
    The batched characterization/calibration paths use this.
    """
    k = np.arange(n + 1) if k is None else np.asarray(k)
    m = op_margin(op, n, k, p)                              # (K,)
    dv = margin_offset_grid(op, p, mfr=mfr, density_gb=density_gb,
                            die_rev=die_rev)                # (3, 3)
    s, b, wp, wm = op_noise(op, n, p, temp_c=temp_c,
                            random_pattern=random_pattern,
                            speed_mts=speed_mts, mfr=mfr,
                            density_gb=density_gb, die_rev=die_rev)
    shift = op_shift(op, n, p)
    x = m[None, None, :] + dv[:, :, None] - shift - p.delta_v
    p1 = mixture_cdf(x, s, b, wp, wm)                       # (3, 3, K)
    ideal_compute = op_ideal("and" if _base_op(op)[0] == "and" else "or", n, k)
    s_analog = np.where(ideal_compute[None, None, :], p1, 1.0 - p1)
    pf = op_pfloor(op, n, p, temp_c=temp_c, random_pattern=random_pattern,
                   speed_mts=speed_mts)
    return (1.0 - pf) * s_analog + 0.5 * pf


def boolean_success_avg_grid(op: str, n: int, **kw) -> np.ndarray:
    """(3, 3) cell-averaged success (k ~ Binomial(n, 1/2)) per region pair."""
    grid = boolean_success_grid(op, n, **kw)
    return grid @ binomial_weights(n)


def binomial_weights(n: int) -> np.ndarray:
    return np.array([math.comb(n, i) for i in range(n + 1)],
                    dtype=np.float64) / 2.0 ** n


def boolean_success_avg(op: str, n: int, **kw) -> float:
    """Average success over uniform random operands (k ~ Binomial(n, 1/2)).

    This matches the paper's per-cell averaged 'success rate' protocol for
    both the random and the all-1s/0s data patterns (both draw row values
    uniformly; they differ in *within-row* content => ``random_pattern``).
    """
    k = np.arange(n + 1)
    s = boolean_success(op, n, k, **kw)
    return float(np.sum(binomial_weights(n) * s))


# ---------------------------------------------------------------------------
# NOT success model
# ---------------------------------------------------------------------------
def not_total_rows(n_dst: int, pattern: str = "N2N") -> int:
    """Total simultaneously driven rows for a NOT with ``n_dst`` destinations.

    N:N  -> n_src = n_dst   => T = 2 n_dst
    N:2N -> n_src = n_dst/2 => T = 1.5 n_dst   (n_dst must be even)
    """
    if pattern.upper() in ("N2N", "N:2N"):
        if n_dst == 1:
            return 2  # 1 destination is only reachable as 1:1
        return n_dst + max(n_dst // 2, 1)
    return 2 * n_dst


def not_success(n_dst: int, *, pattern: str = "N2N",
                p: AnalogParams = DEFAULT_PARAMS, temp_c: float = 50.0,
                src_region: int = MIDDLE, dst_region: int = MIDDLE,
                speed_mts: int = 2666, mfr: str = "sk_hynix",
                density_gb: int = 4, die_rev: str = "A") -> float:
    """Average success rate of the NOT operation with n_dst destination rows."""
    t = not_total_rows(n_dst, pattern)
    z = p.not_z0 - p.not_beta * (t - 2)
    z *= p.not_speed_mult(speed_mts)
    z += p.not_dist_src[src_region] + p.not_dist_dst[dst_region]
    z += p.not_die_offset(mfr, density_gb, die_rev)
    z *= 1.0 - p.not_temp_z * max(temp_c - 50.0, 0.0)
    pf = min(p.not_pf0 + p.not_pf_slope * (t - 2), 0.5)
    pf *= 1.0 + p.temp_pf * max(temp_c - 50.0, 0.0) * 0.1
    return float((1.0 - pf) * phi(z) + 0.5 * pf)


def not_success_grid(n_dst: int, *, pattern: str = "N2N",
                     p: AnalogParams = DEFAULT_PARAMS, temp_c: float = 50.0,
                     speed_mts: int = 2666, mfr: str = "sk_hynix",
                     density_gb: int = 4, die_rev: str = "A") -> np.ndarray:
    """``not_success`` over the (src_region, dst_region) grid: (3, 3) in one
    vectorized evaluation (identical math, region enters additively in z)."""
    t = not_total_rows(n_dst, pattern)
    z0 = (p.not_z0 - p.not_beta * (t - 2)) * p.not_speed_mult(speed_mts)
    src = np.asarray(p.not_dist_src, dtype=np.float64)
    dst = np.asarray(p.not_dist_dst, dtype=np.float64)
    z = z0 + src[:, None] + dst[None, :] \
        + p.not_die_offset(mfr, density_gb, die_rev)
    z = z * (1.0 - p.not_temp_z * max(temp_c - 50.0, 0.0))
    pf = min(p.not_pf0 + p.not_pf_slope * (t - 2), 0.5)
    pf *= 1.0 + p.temp_pf * max(temp_c - 50.0, 0.0) * 0.1
    return (1.0 - pf) * phi(z) + 0.5 * pf


def not_drive_p(n_dst: int, **kw) -> float:
    """P(a destination cell ends with the negated source value)."""
    return not_success(n_dst, **kw)


# ---------------------------------------------------------------------------
# Column-vectorized success for the simulator: given per-column popcounts,
# return P(correct) per column.
# ---------------------------------------------------------------------------
def column_success_probs(op: str, n: int, k_per_col: np.ndarray,
                         **kw) -> np.ndarray:
    k_per_col = np.asarray(k_per_col)
    table = boolean_success(op, n, np.arange(n + 1), **kw)
    return table[k_per_col]


def column_p1_probs(op: str, n: int, k_per_col: np.ndarray, **kw) -> np.ndarray:
    """P(column resolves to logic-1) incl. the floor's coin flip."""
    k_per_col = np.asarray(k_per_col)
    m = op_margin(op, n, np.arange(n + 1))
    p = kw.get("p", DEFAULT_PARAMS)
    p1 = comparator_p1(m, op, n, **kw)
    pf = op_pfloor(op, n, p,
                   temp_c=kw.get("temp_c", 50.0),
                   random_pattern=kw.get("random_pattern", True))
    table = (1.0 - pf) * p1 + 0.5 * pf
    return table[k_per_col]
