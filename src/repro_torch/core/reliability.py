"""Reliability planning over the calibrated success-rate model.

The paper characterizes *raw* success rates (94-98%): far too low for direct
use as a compute substrate.  This module turns the characterization into an
engineering tool, answering: *how do I execute op X at target reliability?*

Strategies (composable):
  1. **Placement** — choose (compute, reference) row regions with the best
     margin offsets (Obs. 6/15: distance to the shared sense amplifiers).
  2. **Operand count** — success *increases* with fan-in (Obs. 11), so wide
     ops are preferred; the planner accounts for it.
  3. **Modular redundancy** — replicate an op R times on *independent*
     sense-amp stripes (different subarray pairs: the per-cell static offsets
     are independent across stripes, not within one) and majority-vote
     in-DRAM.  The visible error rate falls binomially.
  4. **Cell steering** — the paper shows some cells are 100%-reliable
     (Obs. 3); given a measured per-cell success map (from
     ``charz.measure_cell_map``) the planner masks columns below threshold.

The port of ``repro.core.reliability``: the closed-form planning is the
reference's numpy; the per-program path measures its raw success with the
port's :func:`~repro_torch.core.charz.mc_program_success` on ``device``
(default ``"cuda"``), and the cell-steering helpers take the port's
per-cell maps (tensors) as well as numpy arrays.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import analog as A
from .analog import CLOSE, FAR, MIDDLE, AnalogParams


REGIONS = (CLOSE, MIDDLE, FAR)


def best_regions(op: str, n: int, *, p: AnalogParams | None = None,
                 **kw) -> tuple[int, int, float]:
    """-> (compute_region, ref_region, success) maximizing mean success."""
    p = p or A.DEFAULT_PARAMS
    g = A.boolean_success_avg_grid(op, n, p=p, **kw)
    rc, rr = divmod(int(np.argmax(g)), g.shape[1])
    return rc, rr, float(g[rc, rr])


def vote_success(p_bit: float, r: int) -> float:
    """P(majority of r independent replicas is correct) per bit."""
    if r == 1:
        return p_bit
    need = r // 2 + 1
    return float(sum(math.comb(r, i) * p_bit ** i * (1 - p_bit) ** (r - i)
                     for i in range(need, r + 1)))


def vote_success_with_noisy_vote(p_bit: float, r: int, p_vote: float) -> float:
    """Majority vote where the vote itself is computed with noisy in-DRAM
    ops (MAJ3 = 4 native ops each with success p_vote)."""
    ideal = vote_success(p_bit, r)
    # the 4-op MAJ tree is correct iff all its ops are (pessimistic bound)
    return ideal * p_vote ** 4 + (1 - p_vote ** 4) * 0.5


@dataclass(frozen=True)
class RedundancyPlan:
    op: str
    n: int
    replicas: int
    compute_region: int
    ref_region: int
    p_raw: float            # single-op per-bit success
    p_final: float          # post-vote per-bit success
    ops_total: int          # native APA ops incl. vote tree

    @property
    def overhead(self) -> float:
        return self.ops_total / 1.0


def plan(op: str | None = None, n: int | None = None,
         target: float = 0.999999, *, max_replicas: int = 9,
         p: AnalogParams | None = None, noisy_vote: bool = True,
         program=None, mc_success: float | None = None, trials: int = 200,
         row_bits: int = 2048, seed: int = 0, module: str | None = None,
         resident=None, banks: int = 1, draws: str = "device",
         device: str | torch.device = "cuda", **kw) -> RedundancyPlan:
    """Smallest odd replica count hitting ``target`` per-bit success.

    Two raw-success sources:

    * **per-op** (``plan("and", 16, target)``): the closed-form calibrated
      model at the best (compute, reference) region placement — one native
      APA per replica.
    * **per-program** (``plan(target=..., program="add4")`` or a compiled
      :class:`~repro_torch.core.compiler.Program`): the *measured* program-level
      Monte-Carlo success from :func:`charz.mc_program_success` (same
      ``trials``/``seed``/``module``/``resident``/``banks``/``draws``/
      ``device`` knobs; the remaining ``kw`` go to :func:`best_regions`
      and the vote's closed form), so replica
      counts follow whole-program error propagation instead of the
      pessimistic independent-op product — each replica then costs the
      program's native op count.  ``mc_success`` injects a pre-measured
      success rate (skips the MC).  Workload-zoo names
      (``charz.WORKLOAD_PROGRAMS``: ``"bloom_probe"``, ``"bloom_insert"``,
      ``"dot_bitserial"``, optionally fan-in-suffixed) resolve the same
      way — :func:`plan_workload` is the spelled-out form.

    The vote tree is the same in both modes: in-DRAM MAJ3 cascades whose
    own ops succeed at the closed-form 2-input AND rate of the chosen
    placement (``noisy_vote``).
    """
    p = p or A.DEFAULT_PARAMS
    if program is not None:
        from . import charz
        prog = charz.get_program(program) if isinstance(program, str) \
            else program
        p_raw = mc_success if mc_success is not None else \
            charz.mc_program_success(prog, trials=trials, row_bits=row_bits,
                                     seed=seed, module=module,
                                     resident=resident, banks=banks,
                                     draws=draws, device=device)
        ops_each = sum(1 for i in prog.instrs
                       if i.op not in ("input", "const"))
        name = program if isinstance(program, str) else f"<{ops_each} ops>"
        op_label, n_eff = f"program:{name}", ops_each
        rc, rr, _ = best_regions("and", 2, p=p, **kw)
    else:
        if op is None or n is None:
            raise ValueError("plan() needs (op, n) or program=")
        rc, rr, p_raw = best_regions(op, n, p=p, **kw)
        op_label, n_eff, ops_each = op, n, 1
    p_vote = A.boolean_success_avg("and", 2, p=p, compute_region=rc,
                                   ref_region=rr, **kw)
    r, pf, ops = 1, p_raw, ops_each
    for r in range(1, max_replicas + 1, 2):
        pf = (vote_success_with_noisy_vote(p_raw, r, p_vote)
              if (noisy_vote and r > 1) else vote_success(p_raw, r))
        # r replicas + the MAJ3 cascade joining them (4 native ops each)
        ops = r * ops_each + (0 if r == 1 else 4 * (r // 2))
        if pf >= target:
            return RedundancyPlan(op_label, n_eff, r, rc, rr, p_raw, pf, ops)
    # unreachable target: fall back to the largest candidate *as evaluated
    # in the loop* — with noisy_vote=True the old fallback used the ideal
    # vote_success formula, overstating p_final relative to every
    # candidate it had just rejected
    return RedundancyPlan(op_label, n_eff, r, rc, rr, p_raw, pf, ops)


def plan_workload(workload: str, target: float = 0.999999, *,
                  fanin: int | None = None, **kw) -> RedundancyPlan:
    """Replica choice for one workload program (``bloom_probe`` /
    ``bloom_insert`` / ``dot_bitserial``, optionally at an explicit
    fan-in / bit width): :func:`plan` over the compiled program's
    measured Monte-Carlo success, so e.g. a bloom probe that must not
    drop inserted keys gets the replica count its *whole-program* error
    propagation needs, not the per-op pessimism."""
    from . import charz
    if workload not in charz.WORKLOAD_PROGRAMS:
        raise ValueError(f"unknown workload {workload!r} "
                         f"(want one of {charz.WORKLOAD_PROGRAMS})")
    name = workload if fanin is None else f"{workload}{fanin}"
    return plan(target=target, program=name, **kw)


def cell_mask(success_map, threshold: float = 0.999):
    """Column usability mask from a measured per-cell success map (Obs. 3:
    a sizeable population of cells is effectively always-correct): a bool
    tensor on the map's device for a tensor map, a numpy array otherwise."""
    if isinstance(success_map, torch.Tensor):
        return success_map >= threshold
    return np.asarray(success_map) >= threshold


def usable_fraction(success_map, threshold: float = 0.999) -> float:
    mask = cell_mask(success_map, threshold)
    if isinstance(mask, torch.Tensor):
        return float(mask.double().mean())
    return float(np.mean(mask))


def effective_throughput(op: str, n: int, target: float,
                         row_bits: int = 8192, *,
                         p: AnalogParams | None = None, **kw) -> dict:
    """Bits-per-APA delivered at target reliability, after redundancy."""
    pl = plan(op, n, target, p=p, **kw)
    w = row_bits // 2
    return {
        "plan": pl,
        "raw_bits_per_apa": w,
        "effective_bits_per_apa": w / max(pl.ops_total, 1),
        "replicas": pl.replicas,
    }
