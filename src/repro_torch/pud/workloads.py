"""Real workloads lowered to compiled Programs on the PuD substrate.

The port of ``repro.pud.workloads``:

* **Bloom dedup** — bulk insert is a many-input OR-accumulate of the
  per-hash key planes onto the membership plane, probe a many-input
  AND-reduce of the gathered per-hash membership bits
  (:func:`bloom_insert_program` / :func:`bloom_probe_program`, dispatched
  by :class:`~repro_torch.pud.bloom.PudBloomFilter` through
  ``PudEngine.run_program``).
* **Bit-serial binarized dot product** — ``y[m, n] = popcount(x[m] &
  w[n])`` compiles to an AND layer feeding a popcount adder tree
  (``compiler.dot_exprs``): one bit lane per output element, one program
  input pair per bit position.  :func:`dot_bitserial` runs it through an
  engine; on the ``kernel`` backend every compute instruction is one
  kernel launch.

Lanes are built and packed on the engine's device.  Not ported yet:
``dot_bitserial_tree`` (the cross-bank reduction, ROADMAP A-5).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..core import compiler as CC
from ..kernels import ops as kops
from .engine import PudEngine


# ---------------------------------------------------------------------------
# Compiled workload programs
# ---------------------------------------------------------------------------
@lru_cache(maxsize=32)
def bloom_insert_program(n_hashes: int) -> CC.Program:
    """OR-accumulate of ``n_hashes`` hash planes onto ``plane``."""
    return CC.compile_expr(CC.bloom_insert_exprs(n_hashes))


@lru_cache(maxsize=32)
def bloom_probe_program(n_hashes: int) -> CC.Program:
    """AND-reduce of ``n_hashes`` gathered membership-bit planes."""
    return CC.compile_expr(CC.bloom_probe_exprs(n_hashes))


@lru_cache(maxsize=32)
def dot_program(k: int) -> CC.Program:
    """AND + popcount-reduce over k bit positions (``compiler.dot_exprs``)."""
    return CC.compile_expr(CC.dot_exprs(k))


# ---------------------------------------------------------------------------
# Lane packing (one logical bit lane per workload element)
# ---------------------------------------------------------------------------
def pack_lanes(bits, device=None) -> torch.Tensor:
    """(..., L) {0,1} lane vectors -> (..., ceil(L/32)) packed int32
    words (zero-padded; every workload trims back to L on unpack).  A 1-d
    lane vector gives one ``(1, ceil(L/32))`` plane.  ``device`` defaults to
    that of a tensor argument."""
    bits = torch.as_tensor(bits, device=device).to(torch.uint8)
    if bits.dim() == 1:
        bits = bits[None]
    return kops.pack_bits(torch.nn.functional.pad(
        bits, (0, (-bits.shape[-1]) % 32)))


def unpack_lanes(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(1, C) packed plane -> first n lane bits as uint8."""
    return kops.unpack_bits(plane).reshape(-1)[:n]


def _counts_from_planes(outs: dict, lanes: int) -> torch.Tensor:
    """{c0..c{L-1}: (1, C) planes} -> per-lane integer counts (int64)."""
    cnt = None
    for i in range(len(outs)):
        c = unpack_lanes(outs[f"c{i}"], lanes).to(torch.int64) << i
        cnt = c if cnt is None else cnt + c
    return cnt


# ---------------------------------------------------------------------------
# Bit-serial binarized dot product
# ---------------------------------------------------------------------------
def dot_lane_planes(x_bits, w_bits, device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Broadcast (M, K) x and (N, K) w onto M*N output lanes.

    Returns ``(a, b)``, each ``(K, M*N)`` uint8: lane ``m*N + n`` of bit
    position i holds ``x[m, i]`` / ``w[n, i]`` — the operand layout the
    AND layer of ``dot_exprs`` consumes.
    """
    x = torch.as_tensor(x_bits, device=device).to(torch.uint8)
    w = torch.as_tensor(w_bits, device=x.device).to(torch.uint8)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"want (M, K) x and (N, K) w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, n = x.shape[0], w.shape[0]
    a = x.T.repeat_interleave(n, dim=1)     # (K, M*N): lane -> x[m, i]
    b = w.T.repeat(1, m)                    # (K, M*N): lane -> w[n, i]
    return a, b


def dot_bitserial(x_bits, w_bits,
                  engine: PudEngine | None = None) -> torch.Tensor:
    """Binarized dot products via one compiled AND+popcount program.

    ``x_bits`` (M, K) and ``w_bits`` (N, K) are {0,1} matrices (tensors or
    numpy); returns the (M, N) int32 counts ``popcount(x[m] & w[n])`` on
    the engine's device.  The M*N output elements ride the plane's lanes;
    each bit position is one program input pair.
    """
    eng = engine or PudEngine()
    a, b = dot_lane_planes(x_bits, w_bits, device=eng.device)
    k, lanes = a.shape
    pa, pb = pack_lanes(a), pack_lanes(b)              # (K, C) each
    planes = {f"a{i}": pa[i:i + 1] for i in range(k)} \
        | {f"b{i}": pb[i:i + 1] for i in range(k)}
    outs = eng.run_program(dot_program(k), planes)
    m = len(x_bits)
    return _counts_from_planes(outs, lanes).reshape(
        m, lanes // m).to(torch.int32)
