"""The plain Monte-Carlo reference of the paper's success-rate measurement.

One group of the MC pins an activation pair on one bank and runs ``tg``
trials of one APA over the ``W = row_bits / 2`` shared columns
(footnote 6: an inter-subarray op computes on half a row).  Per trial and
column:

* Boolean (§6.1.2): the compute side holds the ``n`` operand bits, the
  reference side ``n - 1`` constant rows (1 for AND / NAND, 0 for OR / NOR)
  and one Frac row at VDD/2.  The sense amp decides
  ``sigma*z + u_n*(k - n/2) - u_n*(r - n/2) + static > thr`` (k = ones among
  the operands, r the reference side's sum), each step one float32
  operation in that order; with probability ``pf`` the activation fails
  and a coin decides.  AND / OR read the compute side, NAND / NOR the
  complement on the reference side.
* NOT (§5): the restored source bit reaches the destination complemented
  where the cell's uniform falls below its success probability, and
  unchanged elsewhere.

The draws are the ones the program makes from the same seed: operands from
one ``torch.Generator`` keyed ``SeedSequence([seed + 1, 0x0BE7A])``, and for
the k-th APA of a bank a generator keyed ``SeedSequence([bank seed,
0x7A1A1, k])`` giving a normal then a uniform plane (the Boolean protocol)
or one uniform plane (NOT).  Groups go to banks round robin.  ``dtype``
is the precision of the decision: float32 as the configuration states, or
a lower one for the control.  Returns the success rate and the result rows
of every group, stacked in group order.
"""
from __future__ import annotations

import numpy as np
import torch

from . import model as M

F32 = np.float32


def _groups(cfg: dict, traffic: dict, mc_seed: int, n_rf: int, n_rl: int):
    """Yield, group by group: the chip seed of its bank, the APA's count
    on that bank, and its pinned pair."""
    banks, groups = cfg["banks"], traffic["groups"]
    seeds = M.bank_seeds(mc_seed, banks)
    plans = [M.stratified_pairs(cfg["module"], seeds[b], n_rf, n_rl, groups,
                                mc_seed) for b in range(min(banks, groups))]
    for g in range(groups):
        b, k = g % banks, g // banks
        yield seeds[b], k + 1, plans[b][k]


def _trials(traffic: dict) -> int:
    return -(-traffic["trials"] // traffic["groups"])


def _gen(device, entropy) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(M.torch_seed(entropy))
    return gen


def _regions(module: dict, pair) -> tuple[int, int]:
    rows = module["rows_per_subarray"]
    return (int(M.regions(pair[0], rows, toward_upper=False)),
            int(M.regions(pair[1], rows, toward_upper=True)))


def boolean(cfg: dict, traffic: dict, mc_seed: int, device,
            dtype: torch.dtype = torch.float32) -> tuple[float, torch.Tensor]:
    """Success rate and (groups * tg, W) uint8 result rows of one
    ``mc_boolean_success(op, n)`` call."""
    module, temp = cfg["module"], cfg["temp_c"]
    op, n = traffic["op"], traffic["n"]
    family, complement = {"and": ("and", False), "nand": ("and", True),
                          "or": ("or", False), "nor": ("or", True)}[op]
    tg, w = _trials(traffic), module["row_bits"] // 2
    operands = _gen(device, [mc_seed + 1, 0x0BE7A])
    # the reference side's level: n - 1 constants and a Frac row at 1/2
    const = 1.0 if family == "and" else 0.0
    ref_sum = F32((n - 1) * const + 0.5)
    ctx = "and" if ref_sum - F32(0.5 * n) >= 0 else "or"
    u = F32(M.u_n(n))
    v_ref = (ref_sum - F32(0.5 * n)) * u
    hits, rows = 0, []
    for chip, k, pair in _groups(cfg, traffic, mc_seed, n, n):
        ops = torch.randint(0, 2, (tg, n, w), generator=operands,
                            device=device, dtype=torch.uint8)
        reg_f, reg_l = _regions(module, pair)
        sc = M.boolean_scalars(ctx, n, module, temp, compute_region=reg_l,
                               ref_region=reg_f)
        static = M.static_offsets(chip, 0, w, ctx, n, module, temp)
        noise = _gen(device, [chip, 0x7A1A1, k])
        z = torch.randn((tg, w), generator=noise, device=device,
                        dtype=torch.float32)
        u0 = torch.rand((tg, w), generator=noise, device=device,
                        dtype=torch.float32)

        def c(x):       # a float32 scalar or tensor in the decision's dtype
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=device).to(dtype)

        v_com = (ops.sum(dim=1, dtype=torch.float32).to(dtype)
                 - c(F32(0.5 * n))) * c(u)
        acc = z.to(dtype) * c(F32(sc["sigma"])) + (v_com - c(v_ref))
        acc = acc + c(static.astype(np.float32))
        out = acc > c(F32(sc["thr"]))
        u0 = u0.to(dtype)
        out = torch.where(u0 < c(F32(sc["pf"])), u0 < c(F32(0.5 * sc["pf"])),
                          out).to(torch.uint8)
        got = 1 - out if complement else out
        want = ops.amin(dim=1) if family == "and" else ops.amax(dim=1)
        want = 1 - want if complement else want
        hits += int((got == want).sum())
        rows.append(got)
    rows = torch.cat(rows)
    return hits / rows.numel(), rows


def not_(cfg: dict, traffic: dict, mc_seed: int, device,
         dtype: torch.dtype = torch.float32) -> tuple[float, torch.Tensor]:
    """Success rate and result rows of one ``mc_not_success(n_dst)`` call.
    The source side drives the fewest rows the decoder offers (n_dst / 2,
    else n_dst: Obs. 5)."""
    module, temp = cfg["module"], cfg["temp_c"]
    n_dst = traffic["n_dst"]
    n_src = next(r for r in (max(n_dst // 2, 1), n_dst)
                 if len(M.pairs(module, M.bank_seeds(mc_seed, 1)[0], r,
                                n_dst)))
    pattern = "N2N" if n_dst == 2 * n_src else "NN"
    tg, w = _trials(traffic), module["row_bits"] // 2
    operands = _gen(device, [mc_seed + 1, 0x0BE7A])
    hits, rows = 0, []
    for chip, k, pair in _groups(cfg, traffic, mc_seed, n_src, n_dst):
        bits = torch.randint(0, 2, (tg, w), generator=operands,
                             device=device, dtype=torch.uint8)
        reg_f, reg_l = _regions(module, pair)
        p_ok = M.not_success(n_dst, pattern, module, temp, src_region=reg_f,
                             dst_region=reg_l)
        cell = torch.as_tensor(M.not_cell_probability(chip, 0, w, p_ok),
                               device=device).to(torch.float32).to(dtype)
        noise = _gen(device, [chip, 0x7A1A1, k])
        draw = torch.rand((tg, w), generator=noise, device=device,
                          dtype=torch.float32).to(dtype)
        got = torch.where(draw < cell, 1 - bits, bits)
        hits += int((got == 1 - bits).sum())
        rows.append(got)
    rows = torch.cat(rows)
    return hits / rows.numel(), rows
