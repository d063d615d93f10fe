"""Torch twin of the closed-form reliability model + one-call MC sampling.

The port of ``repro.core.analog_jax``:

* **Closed form** — the op-context scalars (sigma, spike weights, floor,
  shifts) are host Python math from :mod:`repro_torch.core.analog`; the
  per-pattern success table is float64 tensor math on the device.
* **Sampling** — :func:`sample_boolean_success` / :func:`sample_not_success`
  draw a full ``(trials, width)`` Monte-Carlo estimate of the cell-averaged
  model in one pass on a ``torch.Generator``: random operands, per-column
  popcount, success-table lookup, Bernoulli outcome — the paper's
  10,000-trial protocol at closed-form fidelity, without the command-level
  simulator.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import analog as A
from .analog import DEFAULT_PARAMS
from .simulator import resolve_device


def phi(z: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF."""
    return 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))


def mixture_cdf(x: torch.Tensor, s: float, b: float, w_plus: float,
                w_minus: float) -> torch.Tensor:
    """Torch twin of :func:`repro_torch.core.analog.mixture_cdf`."""
    return ((1.0 - w_plus - w_minus) * phi(x / s)
            + w_plus * phi((x + b) / s)
            + w_minus * phi((x - b) / s))


def _context(op: str, n: int, *, p=DEFAULT_PARAMS, temp_c=50.0,
             random_pattern=True, speed_mts=2666, compute_region=A.MIDDLE,
             ref_region=A.MIDDLE, mfr="sk_hynix", density_gb=4, die_rev="A"):
    """Scalar op context (host Python, identical to the numpy model)."""
    s, b, wp, wm = A.op_noise(op, n, p, temp_c=temp_c,
                              random_pattern=random_pattern,
                              speed_mts=speed_mts, mfr=mfr,
                              density_gb=density_gb, die_rev=die_rev)
    dv = A.margin_offset(op, p, compute_region=compute_region,
                         ref_region=ref_region, mfr=mfr,
                         density_gb=density_gb, die_rev=die_rev)
    shift = A.op_shift(op, n, p) + p.delta_v
    pf = A.op_pfloor(op, n, p, temp_c=temp_c, random_pattern=random_pattern,
                     speed_mts=speed_mts)
    return s, b, wp, wm, dv, shift, pf


def boolean_success_table(op: str, n: int, *,
                          device: str | torch.device = "cuda",
                          **kw) -> torch.Tensor:
    """(n+1,) float64 P(correct) per number of logic-1 operands."""
    dev = resolve_device(device)
    p = kw.get("p", DEFAULT_PARAMS)
    s, b, wp, wm, dv, shift, pf = _context(op, n, **kw)
    k = np.arange(n + 1)
    m = torch.as_tensor(A.op_margin(op, n, k, p), dtype=torch.float64,
                        device=dev)
    ideal = torch.as_tensor(
        A.op_ideal("and" if A._base_op(op)[0] == "and" else "or", n, k),
        device=dev)
    p1 = mixture_cdf(m + dv - shift, s, b, wp, wm)
    return (1.0 - pf) * torch.where(ideal, p1, 1.0 - p1) + 0.5 * pf


def boolean_success_avg(op: str, n: int, *,
                        device: str | torch.device = "cuda",
                        **kw) -> float:
    """Torch twin of :func:`repro_torch.core.analog.boolean_success_avg`."""
    table = boolean_success_table(op, n, device=device, **kw)
    w = torch.as_tensor(A.binomial_weights(n), device=table.device)
    return float(torch.sum(w * table))


def not_success(n_dst: int, **kw) -> float:
    """NOT success: scalar closed form, the numpy model's."""
    return A.not_success(n_dst, **kw)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def sample_boolean_success(op: str, n: int, *, trials: int = 10_000,
                           width: int = 1024, seed: int = 0,
                           device: str | torch.device = "cuda",
                           **kw) -> float:
    """Cell-averaged MC success of the closed-form model in one pass:
    ``trials`` random operand words of ``width`` columns, each (trial,
    column) resolved against the success table."""
    dev = resolve_device(device)
    table = boolean_success_table(op, n, device=dev, **kw)
    gen = _generator(seed, dev)
    bits = torch.randint(0, 2, (n, trials, width), generator=gen,
                         device=dev, dtype=torch.uint8)
    k = bits.sum(dim=0, dtype=torch.int64)              # (T, W) popcounts
    u = torch.rand((trials, width), generator=gen, device=dev,
                   dtype=torch.float64)
    return float((u < table[k]).to(torch.float64).mean())


def sample_not_success(n_dst: int = 1, *, trials: int = 10_000,
                       width: int = 1024, seed: int = 0,
                       device: str | torch.device = "cuda", **kw) -> float:
    """MC estimate of NOT success from the closed-form model, one pass."""
    dev = resolve_device(device)
    p_ok = A.not_success(n_dst, **kw)
    u = torch.rand((trials, width), generator=_generator(seed, dev),
                   device=dev, dtype=torch.float64)
    return float((u < p_ok).to(torch.float64).mean())
