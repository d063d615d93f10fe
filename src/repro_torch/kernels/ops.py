"""Public entry points of the port's kernels, dispatched by tensor device.

A CUDA tensor launches the hand-written Hopper kernel (or raises); a CPU
tensor takes the plain PyTorch version.  Nothing falls back from one to the
other.  ``repro_torch.core.simulator`` calls :func:`senseamp_gather` once
per Boolean APA; :func:`senseamp_resolve` / :func:`senseamp_resolve_trials`
are the slab front ends of the reference's ``repro.kernels.ops``, served by
the same kernel with identity slot indices.
"""
from __future__ import annotations

import torch

from . import ref  # re-exported for tests
from . import senseamp as _senseamp
from .ref import pack_bits, unpack_bits

__all__ = ["pack_bits", "ref", "senseamp_gather", "senseamp_resolve",
           "senseamp_resolve_trials", "unpack_bits"]


def _route(x: torch.Tensor, cuda, plain):
    if x.device.type == "cuda":
        return cuda
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for tensors on {x.device}")


def senseamp_gather(com, com_rows, com_off, ref, ref_rows, ref_off, *,
                    width, u_com, u_ref, static=None, normals=None, sigma=0.0,
                    u0=None, u1=None, pf=0.0, thr=0.0) -> torch.Tensor:
    """Sense-amp resolve of the rows ``com_rows`` / ``ref_rows`` (slot
    indices) of two ``(T, slots, row_bits)`` cell buffers, columns
    ``off .. off+width``; -> (T, width) uint8.  See
    :mod:`repro_torch.kernels.senseamp` for the arithmetic."""
    fn = _route(com, _senseamp.senseamp_gather_cuda,
                _senseamp.senseamp_gather_plain)
    return fn(com, com_rows, com_off, ref, ref_rows, ref_off, width=width,
              u_com=u_com, u_ref=u_ref, static=static, normals=normals,
              sigma=sigma, u0=u0, u1=u1, pf=pf, thr=thr)


def senseamp_resolve_trials(com_cells, ref_cells, static, normals, uniforms,
                            *, u_com: float, u_ref: float, shift: float,
                            pf: float, trial_sigma: float) -> torch.Tensor:
    """Trial-batched resolve: (T, N, W) cell slabs, static (W,) or (T, W),
    normals (T, W), uniforms (2, T, W) (floor flip, coin) -> (T, W) uint8.
    Decides ``v_com − v_ref − shift + static + σ·normal > 0``."""
    return senseamp_gather(
        com_cells, range(com_cells.shape[1]), 0,
        ref_cells, range(ref_cells.shape[1]), 0, width=com_cells.shape[2],
        u_com=u_com, u_ref=u_ref, static=static, normals=normals,
        sigma=trial_sigma, u0=uniforms[0], u1=uniforms[1], pf=pf, thr=shift)


def senseamp_resolve(com_cells, ref_cells, static, normals, uniforms, *,
                     u_com: float, u_ref: float, shift: float, pf: float,
                     trial_sigma: float) -> torch.Tensor:
    """One trial: (N, W) cell slabs, static / normals (W,), uniforms
    (2, W) -> (W,) uint8."""
    return senseamp_resolve_trials(
        com_cells[None], ref_cells[None], static, normals[None],
        uniforms[:, None], u_com=u_com, u_ref=u_ref, shift=shift, pf=pf,
        trial_sigma=trial_sigma)[0]
