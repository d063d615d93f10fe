"""Peaks of the card and the least work of a kernel, from shapes alone.

The peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W
(dense rates); a card set to a lower power limit runs below them, so the
harness prints the limit beside every roofline share.

:func:`senseamp_apa` counts what one sense-amp resolve of the Monte-Carlo
must move and compute, whatever implements it: each of its ``T x W``
decisions reads its ``n_com + n_ref`` float32 cells once, its normal and
its uniform (float32 each) once, and writes one byte; each bank's (W,)
static offsets and its float32 threshold are read once.  The operations
per decision: the two row sums (``n - 1`` adds each), two subtractions and
two products of the charge share, the margin, the noise product and sum,
the static offset, the compare, the floor's two compares and its select.
"""
from __future__ import annotations

#: the card's peaks (NVIDIA H100 SXM data sheet, 700 W)
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_ops_per_s": 67e12}


def senseamp_apa(T: int, W: int, n_com: int, n_ref: int,
                 banks: int = 1) -> tuple[int, int]:
    """(bytes, operations) of one resolve of T trials x W columns."""
    per = 4 * (n_com + n_ref) + 4 + 4 + 1
    nbytes = T * W * per + banks * (4 * W + 4)
    ops = T * W * ((n_com - 1) + (n_ref - 1) + 12)
    return nbytes, ops


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes at the memory's peak or
    operations at the float32 peak, whichever is longer."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["fp32_ops_per_s"])
