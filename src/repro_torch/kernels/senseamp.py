"""Fused charge-share + sense-amp resolve: the Hopper kernel and its plain twin.

Replaces ``repro/kernels/senseamp.py::senseamp_resolve`` (the Pallas TPU
kernel, with its ``senseamp_resolve_trials`` front end).  One decision per
(trial, shared column): charge-share the activated compute-side and
reference-side cells, add the scaled trial noise and the static per-SA
offset, compare against the threshold, apply the activation-failure floor.

:func:`senseamp_gather_cuda` launches ``csrc/senseamp.cu``, which reads the
activated cells straight out of the simulator's ``(T, slots, row_bits)``
cell buffers by slot index and column offset instead of materializing the
``(T, n, W)`` slabs the reference builds on every APA.  It is memory-bound
on an H100: per (trial, column) it moves ``4·(n_com + n_ref)`` bytes of
cells, 4 B of normal, 4 B per uniform plane and 1 B of output, against a
few float operations per byte; neighbouring threads take neighbouring
columns so every load is coalesced.

:func:`senseamp_gather_plain` is the same function in plain PyTorch.  It is
what a CPU tensor gets and what the kernel is checked against on the card.
Both follow the float32 operation order of the numpy reference
(``BankSim._resolve``): row-ordered sums, ``v = u·(Σcells − n/2)``,
``acc = σ·normal``, ``acc += v_com − v_ref``, ``acc += static``,
``acc > thr``, then the floor — one uniform ``u < pf ? u < pf/2 : out``, or
two uniforms ``u0 < pf ? u1 < 0.5 : out``.  Python scalars enter rounded to
the working dtype, where numpy 2's weak-scalar rule casts them.  Working
dtype: that of ``normals`` (float64 for the simulator's scalar mode on the
CPU), else float32.

Per-bank planes (the fused multi-bank episode, ``repro_torch.core.fused``):
with ``bank_trials = T_b`` the trial axis holds ``N = T / T_b`` banks of
``T_b`` trials each, bank-major; ``static`` may then be an ``(N, W)`` plane
and ``thr`` an ``(N,)`` float32 tensor, both read at bank ``t // T_b``.  Each
bank's trials are decided exactly as that bank's own ``(T_b, W)`` call with
``static[b]`` and ``thr[b]`` decides them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

#: kernel launches since the count was last reset (plain calls not counted)
launches = 0

#: most activated rows per side (the decoder activates at most 32)
MAX_ROWS = 64


class _Rows(ctypes.Structure):
    _fields_ = [("idx", ctypes.c_int * MAX_ROWS)]


def round_to(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as a tensor of ``dtype`` holds it (numpy 2 casts a
    weak Python scalar to the array's dtype)."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def _check(com, com_rows, com_off, ref, ref_rows, ref_off, width, static,
           normals, u0, u1, thr=0.0,
           bank_trials=None) -> tuple[int, int, int]:
    """Validate shapes; -> (T, W, N banks)."""
    if com.dim() != 3 or ref.dim() != 3 or com.shape[0] != ref.shape[0]:
        raise ValueError(f"cell buffers must be (T, slots, row_bits) with "
                         f"one T, got {tuple(com.shape)}, {tuple(ref.shape)}")
    t, w = com.shape[0], int(width)
    for name, buf, rows, off in (("com", com, com_rows, com_off),
                                 ("ref", ref, ref_rows, ref_off)):
        if not 1 <= len(rows) <= MAX_ROWS:
            raise ValueError(f"{name}: 1..{MAX_ROWS} rows, got {len(rows)}")
        if min(rows) < 0 or max(rows) >= buf.shape[1]:
            raise IndexError(f"{name}: slot out of range in {list(rows)}")
        if off < 0 or off + w > buf.shape[2]:
            raise IndexError(f"{name}: columns {off}..{off + w} outside a "
                             f"{buf.shape[2]}-bit row")
    tb = t if bank_trials is None else int(bank_trials)
    if tb < 1 or t % tb:
        raise ValueError(f"bank_trials={bank_trials} does not divide the "
                         f"{t} trials into banks")
    nb = t // tb
    if static is not None and tuple(static.shape) not in ((w,), (t, w),
                                                          (nb, w)):
        raise ValueError(f"static must be ({w},), ({t}, {w}) or ({nb}, {w}), "
                         f"got {tuple(static.shape)}")
    if torch.is_tensor(thr) and tuple(thr.shape) != (nb,):
        raise ValueError(f"thr must be a scalar or one per bank ({nb},), got "
                         f"{tuple(thr.shape)}")
    for name, x in (("normals", normals), ("u0", u0), ("u1", u1)):
        if x is not None and tuple(x.shape) != (t, w):
            raise ValueError(f"{name} must be ({t}, {w}), got "
                             f"{tuple(x.shape)}")
    if u1 is not None and u0 is None:
        raise ValueError("u1 (coin plane) needs u0 (flip plane)")
    return t, w, nb


def _per_bank(x: torch.Tensor, nb: int) -> torch.Tensor:
    """A (T, W) plane as its (N, T_b, W) bank view."""
    return x.view(nb, -1, x.shape[-1])


def senseamp_gather_plain(com, com_rows, com_off, ref, ref_rows, ref_off, *,
                          width, u_com, u_ref, static=None, normals=None,
                          sigma=0.0, u0=None, u1=None, pf=0.0,
                          thr=0.0, bank_trials=None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel; see the module doc.  -> (T, W)
    uint8 on the buffers' device."""
    t, _w, nb = _check(com, com_rows, com_off, ref, ref_rows, ref_off, width,
                       static, normals, u0, u1, thr, bank_trials)
    dt = normals.dtype if normals is not None else torch.float32

    def charge(buf, rows, off, u):
        sl = slice(off, off + width)
        s = buf[:, rows[0], sl]
        for r in rows[1:]:
            s = s + buf[:, r, sl]
        return (s - round_to(0.5 * len(rows), torch.float32)) \
            * round_to(u, torch.float32)

    margin = charge(com, com_rows, com_off, u_com) \
        - charge(ref, ref_rows, ref_off, u_ref)
    if normals is not None:
        acc = normals * round_to(sigma, dt) + margin.to(dt)
    else:
        acc = margin.to(dt)
    if static is not None and static.dim() == 2 and static.shape[0] != t:
        acc = (_per_bank(acc, nb) + static.to(dt)[:, None]).view(acc.shape)
    elif static is not None:
        acc = acc + static.to(dt)
    if torch.is_tensor(thr):
        out = (_per_bank(acc, nb) > thr.to(dt)[:, None, None]).view(acc.shape)
    else:
        out = acc > round_to(thr, dt)
    if u0 is not None:
        coin = u1 < 0.5 if u1 is not None else u0 < round_to(0.5 * pf, dt)
        out = torch.where(u0 < round_to(pf, dt), coin, out)
    return out.to(torch.uint8)


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _rows(rows) -> _Rows:
    r = _Rows()
    for i, v in enumerate(rows):
        r.idx[i] = int(v)
    return r


_I64, _F32, _VP, _INT = (ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
                         ctypes.c_int)


def _static_mode(static, t: int) -> int:
    """The kernel's static-plane layout: 0 (W,), 1 (T, W), 2 (N, W)."""
    if static is None or static.dim() == 1:
        return 0
    return 1 if static.shape[0] == t else 2


def _lib():
    from . import build
    lib = build.load("senseamp")
    fn = lib.senseamp_gather
    if fn.argtypes is None:
        side = [_VP, _Rows, _INT, _I64, _I64, _I64, _F32, _F32]
        fn.argtypes = (side + side
                       + [_VP, _INT, _VP, _F32, _VP, _VP, _F32, _F32, _F32,
                          _VP, _INT, _VP, _INT, _INT, _VP])
        fn.restype = ctypes.c_int
    return fn


def senseamp_gather_cuda(com, com_rows, com_off, ref, ref_rows, ref_off, *,
                         width, u_com, u_ref, static=None, normals=None,
                         sigma=0.0, u0=None, u1=None, pf=0.0,
                         thr=0.0, bank_trials=None) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream; -> (T, W) uint8.

    Every tensor must be float32, contiguous and on the same CUDA device
    as the cell buffers; anything else raises."""
    global launches
    t, w, nb = _check(com, com_rows, com_off, ref, ref_rows, ref_off, width,
                      static, normals, u0, u1, thr, bank_trials)
    dev = com.device
    thr_bank = thr if torch.is_tensor(thr) else None
    for name, x in (("com", com), ("ref", ref), ("static", static),
                    ("normals", normals), ("u0", u0), ("u1", u1),
                    ("thr", thr_bank)):
        if x is None:
            continue
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous float32 tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    out = torch.empty((t, w), dtype=torch.uint8, device=dev)
    sides = []
    for buf, rows, off, u in ((com, com_rows, com_off, u_com),
                              (ref, ref_rows, ref_off, u_ref)):
        sides += [_ptr(buf), _rows(rows), len(rows), buf.stride(0),
                  buf.stride(1), int(off), float(np.float32(u)),
                  float(np.float32(0.5 * len(rows)))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(*sides, _ptr(static), _static_mode(static, t),
                     _ptr(normals), float(sigma), _ptr(u0), _ptr(u1),
                     float(pf), float(0.5 * pf),
                     0.0 if thr_bank is not None else float(thr),
                     _ptr(thr_bank), t // nb, _ptr(out), t, w,
                     ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"senseamp kernel launch failed: CUDA error {err}")
    launches += 1
    return out
