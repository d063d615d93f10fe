"""Bit-serial adder and bit-sliced popcount: the Hopper kernels and their twins.

Replaces ``repro/kernels/bitserial.py::add_planes`` (K-bit ripple-carry
adder over LSB-first planes, ``(K, R, C)`` × 2 -> ``(K+1, R, C)``) and
``::bitcount_planes`` (per-bit popcount across N planes as a bit-sliced
counter, ``(N, R, C)`` -> ``(max(1, N.bit_length()), R, C)``), the Pallas
TPU kernels behind ``PudEngine.add`` and ``PudEngine.popcount``.

:func:`add_planes_cuda` / :func:`bitcount_planes_cuda` launch
``csrc/bitserial.cu``: flat word streams as in :mod:`.bitwise`, the carry
(or the counter slices) in registers across the plane loop.  Both are bound
by bytes on an H100.  The counter keeps at most 16 slices in registers, so
the kernel takes N < 65536 planes.

:func:`add_planes_plain` / :func:`bitcount_planes_plain` are the oracles of
:mod:`.ref`: what a CPU tensor gets and what the kernels are held against on
the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .bitwise import _check_planes, _on_card, _stream

#: most counter slices the kernel keeps in registers (N < 2**MAX_SLICES)
MAX_SLICES = 16

#: kernel launches since the counts were last reset (plain calls not
#: counted), per kernel
launches = {"add_planes": 0, "bitcount_planes": 0}


def slices_for(n: int) -> int:
    """Counter planes of an N-plane popcount: ``max(1, N.bit_length())``."""
    return max(1, int(n).bit_length())


def _check_add(a: torch.Tensor, b: torch.Tensor) -> None:
    _check_planes(a, 3, "a")
    _check_planes(b, 3, "b")
    if a.shape != b.shape:
        raise ValueError(f"add_planes: shapes differ, {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")


def add_planes_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin: (K, R, C) + (K, R, C) int32 -> (K+1, R, C)."""
    _check_add(a, b)
    return ref.add_planes(a, b)


def bitcount_planes_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain twin: (N, R, C) int32 -> (max(1, N.bit_length()), R, C)."""
    _check_planes(planes, 3, "planes")
    return ref.bitcount_planes(planes)


_VP, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    from . import build
    lib = build.load("bitserial")
    if lib.add_planes.argtypes is None:
        lib.add_planes.argtypes = [_VP, _VP, _INT, _I64, _VP, _VP]
        lib.add_planes.restype = ctypes.c_int
        lib.bitcount_planes.argtypes = [_VP, _INT, _INT, _I64, _VP, _VP]
        lib.bitcount_planes.restype = ctypes.c_int
    return lib


def add_planes_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the ripple-carry adder on the current stream."""
    _check_add(a, b)
    _on_card(a, "a")
    _on_card(b, "b")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    k, r, c = a.shape
    out = torch.empty((k + 1, r, c), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = _lib().add_planes(a.data_ptr(), b.data_ptr(), k, r * c,
                                out.data_ptr(), _stream(a.device))
    if err != 0:
        raise RuntimeError(f"add_planes kernel launch failed: CUDA error "
                           f"{err}")
    launches["add_planes"] += 1
    return out


def bitcount_planes_cuda(planes: torch.Tensor) -> torch.Tensor:
    """Launch the bit-sliced counter on the current stream."""
    _check_planes(planes, 3, "planes")
    _on_card(planes, "planes")
    n, r, c = planes.shape
    k = slices_for(n)
    if k > MAX_SLICES:
        raise ValueError(f"bitcount_planes kernel takes < 2**{MAX_SLICES} "
                         f"planes, got {n}")
    out = torch.empty((k, r, c), dtype=torch.int32, device=planes.device)
    with torch.cuda.device(planes.device):
        err = _lib().bitcount_planes(planes.data_ptr(), n, k, r * c,
                                     out.data_ptr(), _stream(planes.device))
    if err != 0:
        raise RuntimeError(f"bitcount_planes kernel launch failed: CUDA "
                           f"error {err}")
    launches["bitcount_planes"] += 1
    return out
