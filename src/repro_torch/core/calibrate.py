"""Calibration of the analog reliability model against the paper's claims.

Every quantified statement in the paper is encoded in ``PAPER_CLAIMS`` as a
callable over the model; ``residuals`` evaluates model-vs-paper deltas and
``fit`` runs a (pure-numpy) Nelder-Mead over the free constants of
``AnalogParams``.  The shipped ``analog.DEFAULT_PARAMS`` are the output of
``fit()``.  The port's own copy of ``repro.core.calibrate`` over its copy of
``analog.py``: pure numpy, so residuals, losses and fits equal the
reference's exactly.

Claims are grouped:
  not.*   — §5 NOT characterization (Figs. 7-12)
  op.*    — §6 AND/NAND/OR/NOR characterization (Figs. 15-21)
Units: success rates in percent (0-100).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np

from . import analog as A
from .analog import AnalogParams, CLOSE, FAR, MIDDLE


# ---------------------------------------------------------------------------
# Claim catalogue.  Each entry: name -> (paper_value, weight, fn(params)->model_value)
# ---------------------------------------------------------------------------
_REGIONS = (CLOSE, MIDDLE, FAR)


def _avg(op, n, p, **kw):
    """Cell-averaged success, averaged over the 3x3 distance-region grid —
    the paper's protocol averages over all tested rows, which span the
    regions uniformly (matches the Monte-Carlo simulator's row sampling).
    One vectorized grid evaluation (the fit calls this thousands of times)."""
    return 100.0 * float(np.mean(A.boolean_success_avg_grid(op, n, p=p, **kw)))


def _not(n_dst, p, **kw):
    return 100.0 * float(np.mean(A.not_success_grid(n_dst, p=p, **kw)))


def _not_dist_mean(p, src_region, dst_region):
    """Fig. 9 heatmap cell: mean over all tested destination-row counts."""
    grids = [A.not_success_grid(1, p=p, pattern="NN")]
    grids += [A.not_success_grid(d, p=p, pattern="N2N")
              for d in (2, 4, 8, 16, 32)]
    return 100.0 * float(np.mean([g[src_region, dst_region] for g in grids]))


def _n2n_advantage(p):
    """Obs. 5: mean over dst counts reachable by both patterns."""
    ds = (2, 4, 8, 16)
    adv = [A.not_success(d, p=p, pattern="N2N")
           - A.not_success(d, p=p, pattern="NN") for d in ds]
    return 100.0 * float(np.mean(adv))


def _pattern_delta(op, p):
    """Obs. 16: mean success gain of all-1s/0s over random rows, over n."""
    ns = (2, 4, 8, 16)
    d = [A.boolean_success_avg(op, n, p=p, random_pattern=False)
         - A.boolean_success_avg(op, n, p=p, random_pattern=True) for n in ns]
    return 100.0 * float(np.mean(d))


def _temp_delta_op(op, p):
    """Obs. 17: max |success(95C) - success(50C)| across n."""
    ns = (2, 4, 8, 16)
    d = [abs(A.boolean_success_avg(op, n, p=p, temp_c=95.0)
             - A.boolean_success_avg(op, n, p=p, temp_c=50.0)) for n in ns]
    return 100.0 * float(np.max(d))


def _op_k(op, n, k, p, **kw):
    grid = A.boolean_success_grid(op, n, np.asarray([k]), p=p, **kw)
    return 100.0 * float(np.mean(grid))


def _op_dist_spread(op, p):
    """Obs. 15: max-min of the (compute region x ref region) heatmap of the
    success rate averaged over n in {2,4,8,16}."""
    g = np.mean([A.boolean_success_avg_grid(op, n, p=p)
                 for n in (2, 4, 8, 16)], axis=0)
    return 100.0 * float(g.max() - g.min())


CLAIMS: dict[str, tuple[float, float, Callable[[AnalogParams], float]]] = {
    # ---- NOT (§5) ----
    "not.1dst": (98.37, 10.0, lambda p: _not(1, p)),
    "not.32dst": (7.95, 10.0, lambda p: _not(32, p)),
    "not.n2n_advantage": (9.41, 8.0, _n2n_advantage),
    "not.temp_32dst": (0.20, 2.0, lambda p: abs(_not(32, p, temp_c=95.0) - _not(32, p))),
    "not.dist.mid_far": (85.02, 5.0, lambda p: _not_dist_mean(p, MIDDLE, FAR)),
    "not.dist.far_close": (44.16, 5.0, lambda p: _not_dist_mean(p, FAR, CLOSE)),
    "not.speed.2133_2400": (20.06, 4.0,
                            lambda p: _not(4, p, speed_mts=2133) - _not(4, p, speed_mts=2400)),
    "not.speed.2400_2666": (19.76, 4.0,
                            lambda p: _not(4, p, speed_mts=2666) - _not(4, p, speed_mts=2400)),
    "not.die.hynix_8gb_m_vs_a": (8.05, 2.0,
                                 lambda p: _not(1, p, density_gb=8, die_rev="M")
                                 - _not(1, p, density_gb=8, die_rev="A")),
    "not.die.samsung_a_vs_d": (11.02, 2.0,
                               lambda p: _not(1, p, mfr="samsung", density_gb=8, die_rev="A")
                               - _not(1, p, mfr="samsung", density_gb=8, die_rev="D")),
    # ---- Boolean ops (§6): 16-input averages (abstract / Obs. 10) ----
    "op.and16": (94.94, 10.0, lambda p: _avg("and", 16, p)),
    "op.nand16": (94.94, 10.0, lambda p: _avg("nand", 16, p)),
    "op.or16": (95.85, 10.0, lambda p: _avg("or", 16, p)),
    "op.nor16": (95.87, 10.0, lambda p: _avg("nor", 16, p)),
    # ---- deltas (Obs. 11-13) ----
    "op.and16_minus_and2": (10.27, 8.0,
                            lambda p: _avg("and", 16, p) - _avg("and", 2, p)),
    "op.or2_minus_and2": (10.42, 8.0,
                          lambda p: _avg("or", 2, p) - _avg("and", 2, p)),
    "op.nor2_minus_nand2": (10.60, 6.0,
                            lambda p: _avg("nor", 2, p) - _avg("nand", 2, p)),
    "op.or16_minus_and16": (0.96, 6.0,
                            lambda p: _avg("or", 16, p) - _avg("and", 16, p)),
    "op.and2_minus_nand2": (0.50, 4.0,
                            lambda p: _avg("and", 2, p) - _avg("nand", 2, p)),
    "op.or2_minus_nor2": (0.40, 4.0,
                          lambda p: _avg("or", 2, p) - _avg("nor", 2, p)),
    # ---- Fig. 16 boundary-pattern dips (Obs. 14) ----
    "op.and16.k0_minus_k15": (52.43, 2.0,
                              lambda p: _op_k("and", 16, 0, p) - _op_k("and", 16, 15, p)),
    "op.and4.k0_minus_k4": (45.43, 2.0,
                            lambda p: _op_k("and", 4, 0, p) - _op_k("and", 4, 4, p)),
    "op.or16.k16_minus_k1": (53.66, 2.0,
                             lambda p: _op_k("or", 16, 16, p) - _op_k("or", 16, 1, p)),
    "op.or4.k4_minus_k0": (21.46, 2.0,
                           lambda p: _op_k("or", 4, 4, p) - _op_k("or", 4, 0, p)),
    # ---- data pattern (Obs. 16) ----
    "op.pattern.and": (1.43, 5.0, lambda p: _pattern_delta("and", p)),
    "op.pattern.nand": (1.39, 5.0, lambda p: _pattern_delta("nand", p)),
    "op.pattern.or": (1.98, 5.0, lambda p: _pattern_delta("or", p)),
    "op.pattern.nor": (1.97, 5.0, lambda p: _pattern_delta("nor", p)),
    # ---- temperature (Obs. 17) ----
    "op.temp.and": (1.66, 4.0, lambda p: _temp_delta_op("and", p)),
    "op.temp.or": (1.63, 4.0, lambda p: _temp_delta_op("or", p)),
    # ---- distance spread (Obs. 15) ----
    "op.dist.and": (23.36, 3.0, lambda p: _op_dist_spread("and", p)),
    "op.dist.nand": (23.70, 1.0, lambda p: _op_dist_spread("nand", p)),
    "op.dist.or": (10.42, 3.0, lambda p: _op_dist_spread("or", p)),
    "op.dist.nor": (10.50, 1.0, lambda p: _op_dist_spread("nor", p)),
    # ---- speed (Obs. 18) ----
    "op.speed.nand4.2133_2400": (29.89, 4.0,
                                 lambda p: _avg("nand", 4, p, speed_mts=2133)
                                 - _avg("nand", 4, p, speed_mts=2400)),
    # ---- die (Obs. 19) ----
    "op.die.and2.4gb_a_vs_m": (27.47, 2.0,
                               lambda p: _avg("and", 2, p, density_gb=4, die_rev="A")
                               - _avg("and", 2, p, density_gb=4, die_rev="M")),
    "op.die.and2.8gb_m_vs_a": (2.11, 2.0,
                               lambda p: _avg("and", 2, p, density_gb=8, die_rev="M")
                               - _avg("and", 2, p, density_gb=8, die_rev="A")),
}

#: Monotonicity constraints (Obs. 11): success strictly increases with n.
MONOTONE_OPS = ("and", "nand", "or", "nor")
MONOTONE_NS = (2, 4, 8, 16)


def monotonicity_penalty(p: AnalogParams) -> float:
    pen = 0.0
    for op in MONOTONE_OPS:
        vals = [A.boolean_success_avg(op, n, p=p) for n in MONOTONE_NS]
        for lo, hi in zip(vals, vals[1:], strict=False):
            if hi < lo + 1e-4:   # require increase
                pen += (lo - hi + 1e-3) * 100.0
    return pen


def residuals(p: AnalogParams) -> dict[str, tuple[float, float, float]]:
    """-> {claim: (paper, model, delta)}"""
    out = {}
    for name, (target, _w, fn) in CLAIMS.items():
        model = float(fn(p))
        out[name] = (target, model, model - target)
    return out


def bounds_penalty(p: AnalogParams) -> float:
    """Soft physicality bounds: keep fitted constants in plausible ranges."""
    pen = 0.0

    def rng(v, lo, hi, scale=1.0):
        nonlocal pen
        if v < lo:
            pen += ((lo - v) * scale) ** 2
        if v > hi:
            pen += ((v - hi) * scale) ** 2

    for _s, m in p.speed_sigma:
        rng(m, 0.25, 4.0, 10.0)
    for _s, m in p.speed_pf:
        rng(m, 0.05, 25.0, 2.0)
    for _s, m in p.not_speed_z:
        rng(m, 0.2, 2.0, 10.0)
    for _k, m in p.die_sig:
        rng(m, 0.25, 6.0, 10.0)
    rng(p.w_skew, -0.6, 0.6, 20.0)
    for t in (p.dist_com, p.dist_ref):
        for v in t:
            rng(v, -0.08, 0.08, 100.0)
    for t in (p.not_dist_src, p.not_dist_dst):
        for v in t:
            rng(v, -2.5, 2.5, 5.0)
    for _k, v in p.die_dv:
        rng(v, -0.08, 0.08, 100.0)
    for _k, v in p.not_die_dz:
        rng(v, -2.5, 2.5, 5.0)
    rng(p.b_u, 0.4, 2.5, 10.0)
    rng(p.frac_drift, 0.0, 0.45, 20.0)
    rng(p.sigma_sa, 0.0005, 0.08, 100.0)
    rng(p.eta_cell, 0.0, 1.0, 10.0)
    rng(p.pf_b, 0.2, 2.0, 10.0)
    rng(p.ref_sig, 0.0, 0.5, 10.0)
    return pen


def loss(p: AnalogParams) -> float:
    tot = 0.0
    for target, w, fn in CLAIMS.values():
        model = float(fn(p))
        tot += w * (model - target) ** 2
    tot += 500.0 * monotonicity_penalty(p) ** 2
    tot += 100.0 * bounds_penalty(p)
    return tot


# ---------------------------------------------------------------------------
# Parameter vector <-> AnalogParams
# ---------------------------------------------------------------------------
# (field, transform) — positive params are log-parametrized.
_POS = ("sigma_sa", "eta_cell", "b_u", "frac_drift", "pf_a", "pf_b",
        "sigma_dp", "dp_pf", "temp_sig", "temp_pf", "ref_sig",
        "not_z0", "not_beta", "not_pf0", "not_pf_slope",
        "op_dist_scale_and", "op_dist_scale_or")
_FREE = ("w_a", "w_b", "w_c", "w_skew", "c_pf_cm", "dp_cm")
# tuple-structured params handled specially below.
_SPEED_TUPLES = ("speed_sigma", "speed_pf", "not_speed_z")
_TUPLES = {
    "speed_sigma": [(2133,), (2400,), (3200,)],     # 2666 anchored at 1.0
    "speed_pf": [(2133,), (2400,), (3200,)],
    "not_speed_z": [(2133,), (2400,), (3200,)],
    "dist_com": [0, 2],      # MIDDLE anchored at 0
    "dist_ref": [0, 2],
    "not_dist_src": [0, 2],
    "not_dist_dst": [0, 2],
}


def params_to_vec(p: AnalogParams) -> np.ndarray:
    v = []
    for f in _POS:
        v.append(math.log(max(getattr(p, f), 1e-8)))
    for f in _FREE:
        v.append(getattr(p, f))
    for f, idxs in _TUPLES.items():
        t = getattr(p, f)
        if f in _SPEED_TUPLES:
            d = dict(t)
            for (s,) in idxs:
                v.append(math.log(max(d[s], 1e-8)))
        else:
            for i in idxs:
                v.append(t[i])
    # die offsets / multipliers
    for f in ("die_dv", "not_die_dz"):
        for (_k, val) in getattr(p, f):
            v.append(val)
    for (_k, val) in p.die_sig:
        v.append(math.log(max(val, 1e-8)))
    return np.asarray(v, dtype=np.float64)


def vec_to_params(v: np.ndarray, base: AnalogParams) -> AnalogParams:
    v = list(map(float, v))
    kw = {}
    i = 0
    for f in _POS:
        kw[f] = math.exp(v[i]); i += 1
    for f in _FREE:
        kw[f] = v[i]; i += 1
    for f, idxs in _TUPLES.items():
        t = list(getattr(base, f))
        if f in _SPEED_TUPLES:
            d = dict(t)
            for (s,) in idxs:
                d[s] = math.exp(v[i]); i += 1
            d[2666] = 1.0
            kw[f] = tuple(sorted(d.items()))
        else:
            t = list(t)
            for j in idxs:
                t[j] = v[i]; i += 1
            t[1] = 0.0  # MIDDLE anchor
            kw[f] = tuple(t)
    for f in ("die_dv", "not_die_dz"):
        t = [(k, v[i + j]) for j, (k, _val) in enumerate(getattr(base, f))]
        i += len(t)
        # anchor the first entry (4Gb A-die) at 0
        t[0] = (t[0][0], 0.0)
        kw[f] = tuple(t)
    t = [(k, math.exp(v[i + j])) for j, (k, _val) in enumerate(base.die_sig)]
    i += len(t)
    t[0] = (t[0][0], 1.0)   # 4Gb A-die anchor
    kw["die_sig"] = tuple(t)
    return base.replace(**kw)


# ---------------------------------------------------------------------------
# Nelder-Mead (pure numpy)
# ---------------------------------------------------------------------------
def nelder_mead(f, x0: np.ndarray, *, step: float = 0.15, iters: int = 2000,
                seed: int = 0, verbose: bool = False) -> tuple[np.ndarray, float]:
    rng = np.random.default_rng(seed)
    n = len(x0)
    simplex = [x0]
    for i in range(n):
        x = x0.copy()
        x[i] += step * (1.0 + 0.1 * rng.standard_normal())
        simplex.append(x)
    vals = [f(x) for x in simplex]
    for it in range(iters):
        order = np.argsort(vals)
        simplex = [simplex[i] for i in order]
        vals = [vals[i] for i in order]
        best, worst, second = vals[0], vals[-1], vals[-2]
        if verbose and it % 100 == 0:
            print(f"  nm iter {it}: best={best:.4f} worst={worst:.4f}")
        centroid = np.mean(simplex[:-1], axis=0)
        xr = centroid + (centroid - simplex[-1])          # reflect
        fr = f(xr)
        if fr < best:
            xe = centroid + 2.0 * (centroid - simplex[-1])  # expand
            fe = f(xe)
            simplex[-1], vals[-1] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < second:
            simplex[-1], vals[-1] = xr, fr
        else:
            xc = centroid + 0.5 * (simplex[-1] - centroid)  # contract
            fc = f(xc)
            if fc < worst:
                simplex[-1], vals[-1] = xc, fc
            else:                                            # shrink
                for i in range(1, n + 1):
                    simplex[i] = simplex[0] + 0.5 * (simplex[i] - simplex[0])
                    vals[i] = f(simplex[i])
        if max(vals) - min(vals) < 1e-10:
            break
    order = np.argsort(vals)
    return simplex[order[0]], vals[order[0]]


def fit(base: AnalogParams | None = None, *, iters: int = 2500,
        restarts: int = 3, verbose: bool = False) -> AnalogParams:
    """Fit the analog model to the paper's claims. Returns fitted params."""
    base = base or AnalogParams()

    def obj(v):
        try:
            return loss(vec_to_params(v, base))
        except (OverflowError, ValueError, FloatingPointError):
            return 1e12

    x = params_to_vec(base)
    fx = obj(x)
    for r in range(restarts):
        x1, f1 = nelder_mead(obj, x, step=0.2 / (r + 1), iters=iters,
                             seed=r, verbose=verbose)
        if f1 < fx:
            x, fx = x1, f1
        if verbose:
            print(f"restart {r}: loss={fx:.4f}")
    return vec_to_params(x, base)


def report(p: AnalogParams | None = None) -> str:
    """Human-readable model-vs-paper residual table."""
    p = p or A.DEFAULT_PARAMS
    rows = ["claim,paper,model,delta"]
    for name, (target, model, delta) in sorted(residuals(p).items()):
        rows.append(f"{name},{target:.2f},{model:.2f},{delta:+.2f}")
    rows.append(f"monotonicity_penalty,0.00,{monotonicity_penalty(p):.4f},")
    return "\n".join(rows)


if __name__ == "__main__":
    import sys
    if "--fit" in sys.argv:
        fitted = fit(verbose=True)
        print(report(fitted))
        print("\nFitted params:")
        for f in dataclasses.fields(fitted):
            print(f"    {f.name} = {getattr(fitted, f.name)!r}")
    else:
        print(report())
