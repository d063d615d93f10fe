"""The least work of one launch of the SwiGLU grouped expert product
(``repro_torch.kernels.moe_grouped.grouped_experts_swiglu``), from its
counts alone.

One launch runs ``rows`` sorted rows through the SwiGLU experts that
received them: it must read the gate, up and down weights of each of those
``experts`` once (``3 · d · f`` values each), read its rows in and write
them out (``d`` values each), all in bf16 (2 bytes), and compute ``6 ·
rows · d · f`` operations (the gate, up and down products).  The
activation between them is the kernel's own business and is not counted.
Peaks: the relu² kernel's (``bench/roofline_moe.py``).
"""
from __future__ import annotations

from bench.roofline_moe import PEAKS, bound_s

__all__ = ["PEAKS", "bound_s", "grouped_launch"]


def grouped_launch(experts: int, rows: int, d: int, f: int,
                   elt: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one launch."""
    nbytes = elt * (experts * 3 * d * f + 2 * rows * d)
    return nbytes, 6 * rows * d * f
