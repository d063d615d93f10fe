"""The least work of one launch of the grouped expert product
(``repro_torch.kernels.moe_grouped``), from its counts alone.

One launch runs ``rows`` sorted rows through the relu² experts that
received them: it must read the up and down weights of each of those
``experts`` once (``2 · d · f`` values each), read its rows in and write
them out (``d`` values each), all in bf16 (2 bytes), and compute ``4 ·
rows · d · f`` operations (two products).  The activation between the two
products is the kernel's own business and is not counted.  Peaks: NVIDIA's
H100 SXM data sheet at 700 W, the dense bf16 tensor-core rate.
"""
from __future__ import annotations

#: the card's peaks (NVIDIA H100 SXM data sheet, 700 W)
PEAKS = {"hbm_bytes_per_s": 3.35e12, "bf16_ops_per_s": 989e12}


def grouped_launch(experts: int, rows: int, d: int, f: int,
                   elt: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one launch."""
    nbytes = elt * (experts * 2 * d * f + 2 * rows * d)
    return nbytes, 4 * rows * d * f


def bound_s(nbytes: float, ops: float) -> float:
    """The least time: bytes at the memory's peak or operations at the bf16
    peak, whichever is longer."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["bf16_ops_per_s"])
