"""Hierarchical row-decoder activation model.

The paper (§4) characterizes *which* rows get simultaneously activated by an
``ACT R_F -> PRE -> ACT R_L`` (APA) sequence with violated timings as a
deterministic function of the two row addresses, mediated by the (proprietary)
hierarchical row-decoder circuitry.  The paper treats the decoder as a black
box and reports its behavior as *coverage statistics* (Fig. 5): the fraction
of (R_F, R_L) address pairs that yield each ``N_RF:N_RL`` activation type.

We model the decoder accordingly:

* The activated rows in each subarray always form an *address-aligned block*
  (``N = 2^k`` rows whose addresses share the high bits) — the natural
  consequence of partially-deasserted predecoder stage latches (the paper's
  §4.1 mechanism; see also the PULSAR hypothetical decoder it cites).
* Which block size (and whether the N:N or N:2N pattern) results from a given
  ``(R_F, R_L)`` pair is a *deterministic, module-seeded hash* of the two
  addresses, with category frequencies matching Fig. 5 exactly in
  expectation.  This reproduces the two empirical facts the paper reports:
  the pattern is a repeatable function of the addresses, and its aggregate
  coverage follows Fig. 5.

API: :func:`activation_pattern` is the forward model (addresses -> activated
rows); :func:`find_pair` is the reverse query the row allocator uses
(wanted pattern -> addresses), mirroring how the paper's experiments sweep
address combinations until the desired N:N activation is hit.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .device import ModuleConfig, ActivationSupport

#: Fig. 5 coverage of each N_RF:N_RL activation type (fractions of all tested
#: (R_F, R_L) pairs).  The residual mass is "no simultaneous activation".
FIG5_COVERAGE: tuple[tuple[tuple[int, int], float], ...] = (
    ((1, 1), 0.0023),
    ((1, 2), 0.0015),
    ((2, 2), 0.0260),
    ((2, 4), 0.0153),
    ((4, 4), 0.1158),
    ((4, 8), 0.0542),
    ((8, 8), 0.2452),
    ((8, 16), 0.0795),
    ((16, 16), 0.2435),
    ((16, 32), 0.0382),
)
NO_ACTIVATION_COVERAGE = 1.0 - sum(c for _t, c in FIG5_COVERAGE)


@dataclass(frozen=True)
class Activation:
    """Result of an APA sequence on two neighboring subarrays."""

    n_rf: int                  # rows simultaneously activated in R_F's subarray
    n_rl: int                  # rows simultaneously activated in R_L's subarray
    rows_f: tuple[int, ...]    # activated row indices in R_F's subarray
    rows_l: tuple[int, ...]    # activated row indices in R_L's subarray

    @property
    def kind(self) -> str:
        if self.n_rf == 0:
            return "none"
        return "N:2N" if self.n_rl == 2 * self.n_rf else "N:N"

    @property
    def total_rows(self) -> int:
        return self.n_rf + self.n_rl


NONE_ACTIVATION = Activation(0, 0, (), ())


def _mix64(x: int) -> int:
    """splitmix64 finalizer — deterministic, well-distributed."""
    x &= 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _pair_hash(rf: int, rl: int, seed: int) -> float:
    """Deterministic uniform(0,1) per (R_F, R_L, module seed)."""
    h = _mix64(_mix64(seed * 0x9E3779B97F4A7C15 + rf) ^ (rl * 0xD6E8FEB86659FD93))
    return (h >> 11) / float(1 << 53)


@lru_cache(maxsize=8)
def _category_table(max_rows: int, supports_n2n: bool):
    """-> (thresholds cumsum, categories) honoring module capability."""
    cats, covs = [], []
    for (n_rf, n_rl), cov in FIG5_COVERAGE:
        if not supports_n2n and n_rl != n_rf:
            # N:2N-incapable modules express those address pairs as N:N
            n_rl = n_rf
        if n_rf + n_rl > max_rows:
            # beyond the module's drive capability -> no activation
            continue
        cats.append((n_rf, n_rl))
        covs.append(cov)
    cum = np.cumsum(covs)
    return cum, cats


def _aligned_block(row: int, n: int, rows_per_subarray: int) -> tuple[int, ...]:
    base = (row // n) * n
    base = min(base, rows_per_subarray - n)
    return tuple(range(base, base + n))


@lru_cache(maxsize=8192)
def activation_pattern(module: ModuleConfig, rf: int, rl: int,
                       *, seed: int = 0) -> Activation:
    """Forward decoder model: (R_F, R_L) in neighboring subarrays ->
    activated row sets.  Deterministic per module seed (and cached: the
    model is pure, and batched Monte-Carlo re-queries the same pairs)."""
    if module.activation is ActivationSupport.NONE:
        return NONE_ACTIVATION
    if module.activation is ActivationSupport.SEQUENTIAL:
        # Samsung: sequential two-row activation only -> 1:1 (NOT with 1 dst)
        u = _pair_hash(rf, rl, seed ^ 0x5E0)
        if u < 0.35:  # sequential activation window hit
            return Activation(1, 1, (rf,), (rl,))
        return NONE_ACTIVATION
    cum, cats = _category_table(module.max_simultaneous_rows,
                                module.supports_n2n)
    u = _pair_hash(rf, rl, seed)
    idx = int(np.searchsorted(cum, u))
    if idx >= len(cats):
        return NONE_ACTIVATION
    n_rf, n_rl = cats[idx]
    geom = module.geometry
    return Activation(
        n_rf, n_rl,
        _aligned_block(rf, n_rf, geom.rows_per_subarray),
        _aligned_block(rl, n_rl, geom.rows_per_subarray),
    )


def coverage(module: ModuleConfig, *, seed: int = 0,
             n_rows: int | None = None) -> dict[str, float]:
    """Empirical coverage of each activation type over all (R_F, R_L) pairs
    (vectorized; reproduces Fig. 5)."""
    geom = module.geometry
    n = n_rows or geom.rows_per_subarray
    rf = np.arange(n, dtype=np.uint64)[:, None]
    rl = np.arange(n, dtype=np.uint64)[None, :]
    # vectorized _pair_hash
    M = np.uint64(0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        x = (np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15) + rf)
        for sh, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
            x = ((x ^ (x >> np.uint64(sh))) * np.uint64(mul)) & M
        x ^= x >> np.uint64(31)
        y = (rl * np.uint64(0xD6E8FEB86659FD93)) & M
        h = x ^ y
        for sh, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
            h = ((h ^ (h >> np.uint64(sh))) * np.uint64(mul)) & M
        h ^= h >> np.uint64(31)
    u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    cum, cats = _category_table(module.max_simultaneous_rows,
                                module.supports_n2n)
    idx = np.searchsorted(cum, u)
    out: dict[str, float] = {}
    total = u.size
    for i, (n_rf, n_rl) in enumerate(cats):
        key = f"{n_rf}:{n_rl}"
        out[key] = out.get(key, 0.0) + float(np.sum(idx == i)) / total
    out["none"] = float(np.sum(idx >= len(cats))) / total
    return out


def find_pair(module: ModuleConfig, n_rf: int, n_rl: int, *,
              block_f: int = 0, block_l: int = 0, seed: int = 0,
              max_tries: int | None = None) -> tuple[int, int] | None:
    """Reverse query: find (R_F, R_L) addresses inside the given aligned
    blocks that the decoder maps to an exact ``n_rf:n_rl`` activation of
    those blocks.  Returns None if no such pair exists (capability miss).

    ``block_f``/``block_l`` are block indices (block b = rows
    [b*n, (b+1)*n)).  Mirrors the paper's experimental methodology of
    sweeping R_F/R_L combinations per subarray pair.
    """
    geom = module.geometry
    f_rows = range(block_f * n_rf, (block_f + 1) * n_rf)
    l_rows = range(block_l * n_rl, (block_l + 1) * n_rl)
    want_f = _aligned_block(block_f * n_rf, n_rf, geom.rows_per_subarray)
    want_l = _aligned_block(block_l * n_rl, n_rl, geom.rows_per_subarray)
    tries = 0
    for rf in f_rows:
        for rl in l_rows:
            tries += 1
            if max_tries and tries > max_tries:
                return None
            act = activation_pattern(module, rf, rl, seed=seed)
            if (act.n_rf == n_rf and act.n_rl == n_rl
                    and act.rows_f == want_f and act.rows_l == want_l):
                return rf, rl
    return None


def reachable_patterns(module: ModuleConfig) -> list[tuple[int, int]]:
    """All N_RF:N_RL types this module can express."""
    _cum, cats = _category_table(module.max_simultaneous_rows,
                                 module.supports_n2n)
    if module.activation is ActivationSupport.SEQUENTIAL:
        return [(1, 1)]
    if module.activation is ActivationSupport.NONE:
        return []
    return sorted(set(cats))
