"""1-bit (packed) GEMM through AND / XNOR + popcount: the Hopper kernel and
its plain twin.

Replaces ``repro/kernels/popcount_gemm.py::popcount_gemm``, the Pallas TPU
kernel behind the binarized linear layers (``repro_torch.models.quant``)
and ``ops.popcount_gemm_bits``, the golden twin of the bank-executed
bit-serial dot product (``repro_torch.pud.workloads``).

:func:`popcount_gemm_cuda` launches ``csrc/popcount_gemm.cu``: the packed
words go as they are through the tensor cores' 1-bit path
(``mma.sync.m16n8k256 .b1 .and.popc``: AND counts, 8× the bits of an
int8 ``mma.sync`` at the same instruction rate), one block per 64 × 128
output tile, K in stages of 512 bits through a ``cp.async`` ring.
``xnor`` is ``32·KB − 2·popc(x ^ w)`` with ``popc(x ^ w) = pc(x) + pc(w)
− 2·popc(x & w)``, the row popcounts ``pc`` from a first kernel into
scratch this wrapper allocates: a call is two device kernels for xnor,
one for and.
Ragged edges cost no correction: words past KB and rows past M or N load
as 0, which adds nothing to an AND count (the reference pads with zero
words and subtracts ``32·pk`` from xnor instead).  The bound is the
larger of the bytes (packed operands in, int32 out) and 2·M·N·32·KB
operations at the 1-bit tensor-core rate, 8 × the data sheet's dense int8
1,979 TOP/s (the sheet lists no 1-bit rate); at the serve shapes the
bytes bind.

:func:`popcount_gemm_plain` is the same function in plain PyTorch (the
oracle of :mod:`.ref`, chunked over M): what a CPU tensor gets and what the
kernel is held against on the card.

Packed words are ``int32`` bit patterns; the kernel reads them as unsigned
words.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref

KINDS = ("and", "xnor")

#: kernel launches since the counts were last reset (plain calls not
#: counted); one launch = one call (two device kernels for xnor)
launches = {"popcount_gemm": 0}


def _check(x: torch.Tensor, w: torch.Tensor, kind: str) -> None:
    for name, t in (("x", x), ("w", w)):
        if t.dim() != 2 or t.dtype != torch.int32:
            raise ValueError(f"{name}: want a 2-d int32 tensor of packed "
                             f"words, got {t.dim()}-d {t.dtype}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"x and w disagree on the packed K axis: "
                         f"{tuple(x.shape)} vs {tuple(w.shape)}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def popcount_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                        kind: str = "and") -> torch.Tensor:
    """Plain twin: (M, KB) x (N, KB) int32 -> (M, N) int32."""
    _check(x, w, kind)
    return ref.popcount_gemm(x, w, kind)


_VP, _INT = ctypes.c_void_p, ctypes.c_int


def _lib():
    from . import build
    lib = build.load("popcount_gemm")
    if lib.popcount_gemm.argtypes is None:
        lib.popcount_gemm.argtypes = [_VP, _VP] + [_INT] * 4 + [_VP, _VP,
                                                               _VP]
        lib.popcount_gemm.restype = ctypes.c_int
    return lib


def popcount_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                       kind: str = "and") -> torch.Tensor:
    """Launch the binary GEMM on the current stream; (M, KB) x (N, KB)
    int32 -> (M, N) int32.  Anything the kernel does not take raises."""
    _check(x, w, kind)
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous CUDA tensor, got "
                             f"one on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    (m, kb), n = x.shape, w.shape[0]
    if kb >= 2 ** 26:
        raise ValueError(f"KB = {kb} overflows the kernel's int32 sums "
                         f"(KB < 2²⁶)")
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:        # nothing to launch
        return out
    pc = (torch.empty(m + n, dtype=torch.int32, device=x.device)
          if kind == "xnor" else None)  # row popcounts of x, then of w
    with torch.cuda.device(x.device):
        err = _lib().popcount_gemm(
            x.data_ptr(), w.data_ptr(), m, n, kb, KINDS.index(kind),
            None if pc is None else pc.data_ptr(), out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"popcount_gemm kernel launch failed: CUDA error "
                           f"{err}")
    launches["popcount_gemm"] += 1
    return out
