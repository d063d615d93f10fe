"""N-ary bitwise reduce, complement and majority: the Hopper kernels and
their plain twins.

Replaces ``repro/kernels/bitwise.py::nary_bitwise`` (AND / OR / NAND / NOR /
XOR across the N planes of an ``(N, R, C)`` stack), ``::bitwise_not`` and
``::maj3`` (``(a & b) | (c & (a | b))`` of three planes), the Pallas TPU
kernels behind the engine's plane ops and every compute instruction of a
compiled program on the ``kernel`` backend (``maj3`` is an entry point of
its own: the compiler lowers MAJ to AND / OR).

:func:`nary_bitwise_cuda` / :func:`bitwise_not_cuda` / :func:`maj3_cuda`
launch ``csrc/bitwise.cu``: the planes are flat streams of ``R·C`` 32-bit
words, one thread per 16-byte vector (one word on a ragged length or an
unaligned pointer), the running value in registers across the plane loop.
They are bound by bytes on an H100: ``4·(N + 1)`` bytes per output word
against ``N`` logic operations.

:func:`nary_bitwise_plain` / :func:`bitwise_not_plain` /
:func:`maj3_plain` are the same functions in plain PyTorch (the oracles of
:mod:`.ref`): what a CPU tensor gets and what the kernels are held against
on the card.

Packed planes are ``int32`` bit patterns (PyTorch has no ``~`` on
``torch.uint32``); the kernels read them as unsigned words.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref

OPS = ("and", "or", "nand", "nor", "xor")

#: kernel launches since the counts were last reset (plain calls not
#: counted), per kernel
launches = {"nary_bitwise": 0, "bitwise_not": 0, "maj3": 0}


def _check_planes(x: torch.Tensor, dim: int, name: str) -> None:
    if x.dim() != dim or x.dtype != torch.int32:
        raise ValueError(f"{name}: want a {dim}-d int32 tensor of packed "
                         f"words, got {x.dim()}-d {x.dtype}")


def _check_nary(planes: torch.Tensor, op: str) -> None:
    _check_planes(planes, 3, "planes")
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if planes.shape[0] < 1:
        raise ValueError("nary_bitwise needs at least one plane")


def nary_bitwise_plain(planes: torch.Tensor, op: str) -> torch.Tensor:
    """Plain twin: (N, R, C) int32 -> (R, C) int32."""
    _check_nary(planes, op)
    return ref.nary_bitwise(op, planes)


def bitwise_not_plain(plane: torch.Tensor) -> torch.Tensor:
    """Plain twin: (R, C) int32 -> its complement."""
    _check_planes(plane, 2, "plane")
    return ref.not_(plane)


def _check_maj3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b), ("c", c)):
        _check_planes(t, 2, name)
    if not a.shape == b.shape == c.shape:
        raise ValueError(f"maj3 planes disagree on shape: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")


def maj3_plain(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Plain twin: three (R, C) int32 -> (R, C) int32 bitwise majority."""
    _check_maj3(a, b, c)
    return ref.maj3(a, b, c)


_VP, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    from . import build
    lib = build.load("bitwise")
    if lib.nary_bitwise.argtypes is None:
        lib.nary_bitwise.argtypes = [_VP, _INT, _I64, _INT, _VP, _VP]
        lib.nary_bitwise.restype = ctypes.c_int
        lib.bitwise_not.argtypes = [_VP, _I64, _VP, _VP]
        lib.bitwise_not.restype = ctypes.c_int
        lib.maj3.argtypes = [_VP, _VP, _VP, _I64, _VP, _VP]
        lib.maj3.restype = ctypes.c_int
    return lib


def _on_card(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous CUDA tensor, got one on "
                         f"{x.device} (contiguous={x.is_contiguous()})")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def nary_bitwise_cuda(planes: torch.Tensor, op: str) -> torch.Tensor:
    """Launch the N-ary reduce on the current stream; (N, R, C) int32 ->
    (R, C) int32.  Anything the kernel does not take raises."""
    _check_nary(planes, op)
    _on_card(planes, "planes")
    n, r, c = planes.shape
    out = torch.empty((r, c), dtype=torch.int32, device=planes.device)
    with torch.cuda.device(planes.device):
        err = _lib().nary_bitwise(planes.data_ptr(), n, r * c,
                                  OPS.index(op), out.data_ptr(),
                                  _stream(planes.device))
    if err != 0:
        raise RuntimeError(f"nary_bitwise kernel launch failed: CUDA error "
                           f"{err}")
    launches["nary_bitwise"] += 1
    return out


def bitwise_not_cuda(plane: torch.Tensor) -> torch.Tensor:
    """Launch the complement on the current stream; (R, C) int32 ->
    (R, C) int32."""
    _check_planes(plane, 2, "plane")
    _on_card(plane, "plane")
    out = torch.empty_like(plane)
    with torch.cuda.device(plane.device):
        err = _lib().bitwise_not(plane.data_ptr(), plane.numel(),
                                 out.data_ptr(), _stream(plane.device))
    if err != 0:
        raise RuntimeError(f"bitwise_not kernel launch failed: CUDA error "
                           f"{err}")
    launches["bitwise_not"] += 1
    return out


def maj3_cuda(a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """Launch the bitwise majority on the current stream; three (R, C)
    int32 -> (R, C) int32."""
    _check_maj3(a, b, c)
    for name, t in (("a", a), ("b", b), ("c", c)):
        _on_card(t, name)
    if not a.device == b.device == c.device:
        raise ValueError(f"maj3 planes on {a.device}, {b.device}, "
                         f"{c.device}")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = _lib().maj3(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                          a.numel(), out.data_ptr(), _stream(a.device))
    if err != 0:
        raise RuntimeError(f"maj3 kernel launch failed: CUDA error {err}")
    launches["maj3"] += 1
    return out
