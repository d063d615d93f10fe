"""The simulated DDR4 chip, written out plainly: the reference's model.

A straightforward restatement, in numpy, of the paper's analog model of
the APA command as the repository defines it (Yüksel et al., "Functionally-
Complete Boolean Logic in Real DRAM Chips", HPCA 2024: the decoder's
activation coverage of Fig. 5, the charge-sharing comparator of §6.1.2 and
the NOT drive of §5, with the constants fitted against the paper's claims).
It is frozen here so that the benchmark's judgement of a success rate does
not move when the program under test moves.  It imports neither the program
nor anything it made: the chip is rebuilt from the configuration file and
the seed.

What it gives the Monte-Carlo reference (:mod:`bench.reference.mc`):

* :func:`bank_seeds` — the chip identity of each bank of an array;
* :func:`pairs` — every (R_F, R_L) row pair of a subarray pair that the
  decoder maps to an ``n_rf:n_rl`` activation (the reverse-engineering sweep
  of §4.2), in row-major order;
* :func:`stratified_pairs` — the MC's pinned pair per group, cycling the
  3 x 3 grid of (R_F region, R_L region);
* the comparator's scalars (:func:`boolean_scalars`) and static per-SA
  offsets (:func:`static_offsets`), and the NOT's per-cell success
  probability (:func:`not_cell_probability`).
"""
from __future__ import annotations

import math

import numpy as np

VDD = 1.0
#: share of the comparator's Gaussian sigma that is static (per cell)
STATIC_SPLIT = 0.8
#: per-cell spread of the NOT's success around its mean (in z units)
NOT_SPREAD = 0.75
CLOSE, MIDDLE, FAR = 0, 1, 2

#: Fig. 5: share of (R_F, R_L) address pairs giving each N_RF:N_RL type
FIG5_COVERAGE = (((1, 1), 0.0023), ((1, 2), 0.0015), ((2, 2), 0.0260),
                 ((2, 4), 0.0153), ((4, 4), 0.1158), ((4, 8), 0.0542),
                 ((8, 8), 0.2452), ((8, 16), 0.0795), ((16, 16), 0.2435),
                 ((16, 32), 0.0382))

#: the fitted constants of the analog model (volts unless stated)
PARAMS = {
    "r_blcap": 6.0, "sigma_sa": 0.0046003, "eta_cell": 0.029612,
    "b_u": 1.75117, "w_a": 2.10037, "w_b": -4.21799, "w_c": 0.208423,
    "w_skew": 0.604254, "frac_drift": 0.425763, "delta_v": 0.0,
    "pf_a": 0.0042215, "pf_b": 0.722803, "c_pf_cm": 0.476329,
    "sigma_dp": 0.0075321, "dp_pf": 0.537118,
    "dp_cm": -0.392083, "temp_sig": 0.0027459, "temp_pf": 0.0138937,
    "speed_sigma": {2133: 0.61092, 2400: 4.00454, 2666: 1.0, 3200: 0.24599},
    "speed_pf": {2133: 0.24458, 2400: 24.5048, 2666: 1.0, 3200: 0.59361},
    "die_sig": {("sk_hynix", 4, "A"): 1.0, ("sk_hynix", 4, "M"): 1.63785,
                ("sk_hynix", 8, "A"): 6.00313, ("sk_hynix", 8, "M"): 5.61396},
    "dist_com": (-0.000894, 0.0, 0.056424),
    "dist_ref": (-0.058861, 0.0, -0.007911),
    "op_dist_scale_and": 2.09989, "op_dist_scale_or": 1.66932,
    "die_dv": {("sk_hynix", 4, "A"): 0.0, ("sk_hynix", 4, "M"): -0.059470,
               ("sk_hynix", 8, "A"): 0.070779, ("sk_hynix", 8, "M"): -0.003394},
    "not_z0": 5.03222, "not_beta": 0.165281, "not_pf0": 0.0101626,
    "not_pf_slope": 0.0026881, "not_temp_z": 0.00006,
    "not_speed_z": {2133: 1.01319, 2400: 0.60506, 2666: 1.0, 3200: 0.67328},
    "not_dist_src": (-1.42174, 0.0, -2.50518),
    "not_dist_dst": (-1.49787, 0.0, 1.39083),
    "not_die_dz": {("sk_hynix", 4, "A"): 0.0, ("sk_hynix", 4, "M"): -0.45821,
                   ("sk_hynix", 8, "A"): -1.23202,
                   ("sk_hynix", 8, "M"): -0.05664,
                   ("samsung", 4, "F"): 1.48920, ("samsung", 8, "A"): 1.96393,
                   ("samsung", 8, "D"): -1.32102},
}

_M64 = 0xFFFFFFFFFFFFFFFF
_GOLDEN = 0x9E3779B97F4A7C15
_ROW_MUL = 0xD6E8FEB86659FD93


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------
def torch_seed(entropy) -> int:
    """A 63-bit ``torch.Generator`` seed from a numpy seed sequence's first
    two 32-bit words."""
    lo, hi = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & ((1 << 63) - 1)


def bank_seeds(seed: int, banks: int) -> list[int]:
    """Chip identity of each bank: bank 0 is ``seed``; the others take the
    spawned children of ``SeedSequence([seed, 0xBA2C5])``."""
    kids = np.random.SeedSequence([seed, 0xBA2C5]).spawn(banks - 1)
    return [seed] + [int(c.generate_state(1, np.uint64)[0]) for c in kids]


def mix64(x: int) -> int:
    """splitmix64's finalizer on a Python int."""
    x &= _M64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


# ---------------------------------------------------------------------------
# decoder: which rows an APA activates
# ---------------------------------------------------------------------------
def categories(module: dict) -> tuple[np.ndarray, list]:
    """Cumulative Fig. 5 coverage and the activation type of each interval,
    for what this module can drive."""
    cats, covs = [], []
    for (n_rf, n_rl), cov in FIG5_COVERAGE:
        if not module["supports_n2n"] and n_rl != n_rf:
            n_rl = n_rf
        if n_rf + n_rl > module["max_simultaneous_rows"]:
            continue
        cats.append((n_rf, n_rl))
        covs.append(cov)
    return np.cumsum(covs), cats


def pair_uniforms(seed: int, rows: int) -> np.ndarray:
    """The decoder's uniform in [0, 1) of every (R_F, R_L) pair of one
    subarray pair of the chip ``seed``: (rows, rows) float64."""
    m = np.uint64(_M64)
    rf = np.arange(rows, dtype=np.uint64)[:, None]
    rl = np.arange(rows, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        x = np.uint64(seed & _M64) * np.uint64(_GOLDEN) + rf
        for sh, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
            x = ((x ^ (x >> np.uint64(sh))) * np.uint64(mul)) & m
        x ^= x >> np.uint64(31)
        h = x ^ ((rl * np.uint64(_ROW_MUL)) & m)
        for sh, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
            h = ((h ^ (h >> np.uint64(sh))) * np.uint64(mul)) & m
        h ^= h >> np.uint64(31)
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def pairs(module: dict, seed: int, n_rf: int, n_rl: int) -> np.ndarray:
    """(P, 2) int64 (R_F, R_L) rows giving an ``n_rf:n_rl`` activation, in
    the order of the coverage intervals, each in row-major order."""
    if module["activation"] != "simultaneous":
        raise ValueError("the reference models simultaneous activation only")
    cum, cats = categories(module)
    idx = np.searchsorted(cum, pair_uniforms(seed, module["rows_per_subarray"]))
    out = [np.stack(np.nonzero(idx == i), axis=1)
           for i, cat in enumerate(cats) if cat == (n_rf, n_rl)]
    return np.concatenate(out) if out else np.zeros((0, 2), np.int64)


def regions(rows, rows_per_subarray: int, *, toward_upper: bool) -> np.ndarray:
    """Distance region (0 close, 1 middle, 2 far: thirds of the subarray) of
    rows with respect to the sense-amp stripe the APA uses."""
    rows = np.asarray(rows)
    pos = rows if toward_upper else rows_per_subarray - 1 - rows
    return np.minimum(pos // (rows_per_subarray // 3), 2).astype(np.int64)


def stratified_pairs(module: dict, chip_seed: int, n_rf: int, n_rl: int,
                     groups: int, mc_seed: int) -> list[tuple[int, int]]:
    """The MC's pinned (R_F, R_L) pair of each group on one bank: group g
    takes a scrambled pair of region cell ``g % 9`` of the (R_F region,
    R_L region) grid.  R_F is in subarray 0, R_L in subarray 1, so R_F's
    stripe lies below it and R_L's above."""
    ps = pairs(module, chip_seed, n_rf, n_rl)
    if len(ps) == 0:
        raise ValueError(f"no {n_rf}:{n_rl} pairs on this chip")
    rows = module["rows_per_subarray"]
    reg_f = regions(ps[:, 0], rows, toward_upper=False)
    reg_l = regions(ps[:, 1], rows, toward_upper=True)
    combos = [(a, b) for a in range(3) for b in range(3)]
    out = []
    for g in range(groups):
        a, b = combos[g % 9]
        idxs = np.nonzero((reg_f == a) & (reg_l == b))[0]
        if len(idxs) == 0:
            idxs = np.arange(len(ps))
        k = mix64(g * _GOLDEN + mc_seed) % len(idxs)
        out.append(tuple(int(v) for v in ps[idxs[k]]))
    return out


# ---------------------------------------------------------------------------
# the analog model
# ---------------------------------------------------------------------------
def phi(z):
    """Standard normal CDF, elementwise (math.erf)."""
    z = np.asarray(z, dtype=np.float64)
    erf = np.frompyfunc(math.erf, 1, 1)
    return 0.5 * (1.0 + np.asarray(erf(z / math.sqrt(2.0)), dtype=np.float64))


def norm_ppf(q):
    """Acklam's rational approximation of the inverse normal CDF."""
    q = np.clip(np.asarray(q, dtype=np.float64), 1e-12, 1 - 1e-12)
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    out = np.empty_like(q)
    lo, hi = q < 0.02425, q > 1 - 0.02425
    mid = ~(lo | hi)
    if np.any(mid):
        x = q[mid] - 0.5
        r = x * x
        out[mid] = ((((((a[0]*r+a[1])*r+a[2])*r+a[3])*r+a[4])*r+a[5])*x /
                    (((((b[0]*r+b[1])*r+b[2])*r+b[3])*r+b[4])*r+1))
    if np.any(lo):
        r = np.sqrt(-2*np.log(q[lo]))
        out[lo] = (((((c[0]*r+c[1])*r+c[2])*r+c[3])*r+c[4])*r+c[5]) / \
                  ((((d[0]*r+d[1])*r+d[2])*r+d[3])*r+1)
    if np.any(hi):
        r = np.sqrt(-2*np.log(1-q[hi]))
        out[hi] = -((((((c[0]*r+c[1])*r+c[2])*r+c[3])*r+c[4])*r+c[5]) /
                    ((((d[0]*r+d[1])*r+d[2])*r+d[3])*r+1))
    return out


def u_n(n: int) -> float:
    """Bitline swing per cell with ``n`` cells charge-sharing."""
    return VDD / (PARAMS["r_blcap"] + n)


def _sigmoid(x: float) -> float:
    if x >= 0:
        return 1.0 / (1.0 + math.exp(-x))
    e = math.exp(x)
    return e / (1.0 + e)


def _die(module: dict) -> tuple:
    return (module["manufacturer"], module["density_gb"], module["die_rev"])


def op_noise(family: str, n: int, module: dict,
             temp_c: float) -> tuple[float, float, float, float]:
    """(s, b, w_plus, w_minus) of the comparator's offset mixture for a
    random-pattern op of fan-in ``n``; ``family`` is ``"and"`` or ``"or"``."""
    p = PARAMS
    u, sgn = u_n(n), (1.0 if family == "and" else -1.0)
    s = math.sqrt(p["sigma_sa"] ** 2 + (p["eta_cell"] * u) ** 2)
    s *= p["speed_sigma"].get(module["speed_mts"], 1.0)
    s *= p["die_sig"].get(_die(module), 1.0)
    s = math.sqrt(s ** 2 + p["sigma_dp"] ** 2)
    s *= 1.0 + p["temp_sig"] * max(temp_c - 50.0, 0.0)
    b = p["b_u"] * u
    w = 0.5 * _sigmoid(p["w_a"] * math.log(n) + p["w_b"] + p["w_c"] * sgn)
    skew = max(min(p["w_skew"] * sgn, 0.9), -0.9)
    w_plus = min(w * (1.0 + skew), 0.95)
    w_minus = max(min(w * (1.0 - skew), 0.95), 0.0)
    if w_plus + w_minus > 0.98:
        w_plus, w_minus = (0.98 * w_plus / (w_plus + w_minus),
                           0.98 * w_minus / (w_plus + w_minus))
    return s, b, w_plus, w_minus


def boolean_scalars(family: str, n: int, module: dict, temp_c: float,
                    compute_region: int, ref_region: int) -> dict:
    """The comparator's scalars for one APA of the Boolean protocol: the
    trial noise's sigma, the decision threshold (margin offset of the rows'
    distances and the die, plus the Frac row's drift) and the activation
    failure floor ``pf``."""
    p = PARAMS
    u, sgn = u_n(n), (1.0 if family == "and" else -1.0)
    scale = p["op_dist_scale_and"] if family == "and" else p["op_dist_scale_or"]
    dv = scale * (p["dist_com"][compute_region] + p["dist_ref"][ref_region])
    dv += p["die_dv"].get(_die(module), 0.0)
    s = op_noise(family, n, module, temp_c)[0]
    shift = p["frac_drift"] * u * sgn
    cm = sgn * u * (n - 1) / (2.0 * VDD)
    pf = p["pf_a"] * (2.0 * n) ** p["pf_b"]
    pf *= math.exp(p["c_pf_cm"] * cm)
    pf *= p["speed_pf"].get(module["speed_mts"], 1.0)
    pf *= 1.0 + p["dp_pf"] * math.exp(p["dp_cm"] * cm)
    pf *= 1.0 + p["temp_pf"] * max(temp_c - 50.0, 0.0)
    return {"sigma": math.sqrt(max(1.0 - STATIC_SPLIT ** 2, 0.0)) * s,
            "thr": -(dv - shift - p["delta_v"]),
            "pf": float(np.clip(pf, 0.0, 0.75))}


def static_latents(chip_seed: int, stripe: int, width: int):
    """Two uniforms per sense amp of one stripe of the chip."""
    rng = np.random.default_rng(
        np.random.SeedSequence([chip_seed, 0xC0FFEE, stripe]))
    return rng.random(width), rng.random(width)


def static_offsets(chip_seed: int, stripe: int, width: int, family: str,
                   n: int, module: dict, temp_c: float) -> np.ndarray:
    """Static offset [V] of each sense amp of a stripe: the spike at ±b of
    the mixture picked by the first latent, the Gaussian body by the
    second.  (width,) float64."""
    xi1, xi2 = static_latents(chip_seed, stripe, width)
    s, b, wp, wm = op_noise(family, n, module, temp_c)
    comp = np.where(xi1 < wm, -1.0, np.where(xi1 > 1.0 - wp, 1.0, 0.0))
    return comp * b + STATIC_SPLIT * s * norm_ppf(xi2)


def not_success(n_dst: int, pattern: str, module: dict, temp_c: float,
                src_region: int, dst_region: int) -> float:
    """Mean success of a NOT driving ``n_dst`` destination rows."""
    p = PARAMS
    if pattern == "N2N":
        t = 2 if n_dst == 1 else n_dst + max(n_dst // 2, 1)
    else:
        t = 2 * n_dst
    z = p["not_z0"] - p["not_beta"] * (t - 2)
    z *= p["not_speed_z"].get(module["speed_mts"], 1.0)
    z += p["not_dist_src"][src_region] + p["not_dist_dst"][dst_region]
    z += p["not_die_dz"].get(_die(module), 0.0)
    z *= 1.0 - p["not_temp_z"] * max(temp_c - 50.0, 0.0)
    pf = min(p["not_pf0"] + p["not_pf_slope"] * (t - 2), 0.5)
    pf *= 1.0 + p["temp_pf"] * max(temp_c - 50.0, 0.0) * 0.1
    return float((1.0 - pf) * phi(z) + 0.5 * pf)


def not_cell_probability(chip_seed: int, stripe: int, width: int,
                         p_ok: float) -> np.ndarray:
    """Each cell's NOT success probability: a static spread around the
    mean ``p_ok`` that keeps the cell mean at ``p_ok``
    (E[Phi(a + s Z)] = Phi(a / sqrt(1 + s^2))).  (width,) float64."""
    xi1, _xi2 = static_latents(chip_seed, stripe, width)
    a = norm_ppf(np.clip(p_ok, 1e-9, 1 - 1e-9)) * math.sqrt(
        1.0 + NOT_SPREAD ** 2)
    return phi(a + NOT_SPREAD * norm_ppf(xi1))
