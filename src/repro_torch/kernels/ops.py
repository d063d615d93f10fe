"""Public entry points of the port's kernels, dispatched by tensor device.

A CUDA tensor launches the hand-written Hopper kernel (or raises); a CPU
tensor takes the plain PyTorch version.  Nothing falls back from one to the
other.  ``repro_torch.core.simulator`` calls :func:`senseamp_gather` once
per Boolean APA; :func:`senseamp_resolve` / :func:`senseamp_resolve_trials`
are the slab front ends of the reference's ``repro.kernels.ops``, served by
the same kernel with identity slot indices.  ``repro_torch.pud.engine``'s
``kernel`` backend calls the plane ops: :func:`nary_bitwise`,
:func:`bitwise_not`, :func:`add_planes` and :func:`bitcount_planes`;
``repro_torch.models.quant`` the binary GEMM :func:`popcount_gemm`;
:func:`popcount_gemm_bits` is the golden twin of the bank-executed dot
product (``repro_torch.pud.workloads``); :func:`maj3` is an entry point of
its own.  ``repro_torch.models.layers.apply_attention`` calls
:func:`flash_attention` once per layer, and in training (through the
``fused_attention`` autograd function) :func:`flash_attention_bwd` once
per layer of the backward.
"""
from __future__ import annotations

import torch

from . import bitserial as _bitserial
from . import bitwise as _bitwise
from . import flash_attention as _fa
from . import popcount_gemm as _pcg
from . import ref  # re-exported for tests
from . import senseamp as _senseamp
from .ref import pack_bits, unpack_bits

__all__ = ["add_planes", "bitcount_planes", "bitwise_not", "flash_attention",
           "flash_attention_bwd", "maj3", "nary_bitwise", "nary_bitwise_bits", "pack_bits",
           "popcount_gemm", "popcount_gemm_bits", "ref", "senseamp_gather",
           "senseamp_resolve", "senseamp_resolve_trials", "unpack_bits"]


def _route(x: torch.Tensor, cuda, plain):
    if x.device.type == "cuda":
        return cuda
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for tensors on {x.device}")


def senseamp_gather(com, com_rows, com_off, ref, ref_rows, ref_off, *,
                    width, u_com, u_ref, static=None, normals=None, sigma=0.0,
                    u0=None, u1=None, pf=0.0, thr=0.0,
                    bank_trials=None) -> torch.Tensor:
    """Sense-amp resolve of the rows ``com_rows`` / ``ref_rows`` (slot
    indices) of two ``(T, slots, row_bits)`` cell buffers, columns
    ``off .. off+width``; -> (T, width) uint8.  With ``bank_trials`` the
    trial axis holds banks of that many trials, and ``static`` / ``thr``
    may be given per bank.  See :mod:`repro_torch.kernels.senseamp` for the
    arithmetic."""
    fn = _route(com, _senseamp.senseamp_gather_cuda,
                _senseamp.senseamp_gather_plain)
    return fn(com, com_rows, com_off, ref, ref_rows, ref_off, width=width,
              u_com=u_com, u_ref=u_ref, static=static, normals=normals,
              sigma=sigma, u0=u0, u1=u1, pf=pf, thr=thr,
              bank_trials=bank_trials)


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


# ---------------------------------------------------------------------------
# Packed bit-plane ops (int32 bit patterns)
# ---------------------------------------------------------------------------
def nary_bitwise(planes: torch.Tensor, op: str) -> torch.Tensor:
    """(N, R, C) packed int32 -> (R, C); op in {and, or, nand, nor, xor}."""
    return _route(planes, _bitwise.nary_bitwise_cuda,
                  _bitwise.nary_bitwise_plain)(planes, op)


def bitwise_not(plane: torch.Tensor) -> torch.Tensor:
    """(R, C) packed int32 -> its complement (the paper's NOT)."""
    return _route(plane, _bitwise.bitwise_not_cuda,
                  _bitwise.bitwise_not_plain)(plane)


def maj3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Bitwise 3-input majority of three (R, C) packed int32 planes."""
    return _route(a, _bitwise.maj3_cuda, _bitwise.maj3_plain)(a, b, c)


def add_planes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K, R, C) + (K, R, C) packed planes, LSB first -> (K+1, R, C)."""
    return _route(a, _bitserial.add_planes_cuda,
                  _bitserial.add_planes_plain)(a, b)


def bitcount_planes(planes: torch.Tensor) -> torch.Tensor:
    """(N, R, C) -> (max(1, N.bit_length()), R, C) per-bit popcount,
    bit-sliced, LSB first."""
    return _route(planes, _bitserial.bitcount_planes_cuda,
                  _bitserial.bitcount_planes_plain)(planes)


def nary_bitwise_bits(bit_vectors: torch.Tensor, op: str) -> torch.Tensor:
    """(N, W) uint8 in {0,1} -> (W,) uint8.  Pads W to a multiple of 32."""
    _n, w = bit_vectors.shape
    bv = torch.nn.functional.pad(bit_vectors, (0, (-w) % 32))
    out = nary_bitwise(pack_bits(bv)[:, None, :], op)     # (1, B)
    return unpack_bits(out)[0, :w]


def popcount_gemm(x: torch.Tensor, w: torch.Tensor, *,
                  kind: str = "and") -> torch.Tensor:
    """(M, KB) x (N, KB) packed int32 -> (M, N) int32 binary GEMM:
    ``Σ popcount(x & w)`` ("and") or ``32·KB − 2·Σ popcount(x ^ w)``
    ("xnor")."""
    return _route(x, _pcg.popcount_gemm_cuda,
                  _pcg.popcount_gemm_plain)(x, w, kind)


def popcount_gemm_bits(x_bits, w_bits, *, kind: str = "and",
                       device=None) -> torch.Tensor:
    """Binary GEMM over unpacked {0,1} matrices: (M, K) x (N, K) -> (M, N).

    Packs both operands (K zero-padded to a multiple of 32) and calls
    :func:`popcount_gemm`.  ``kind="and"`` is padding-safe as packed;
    ``kind="xnor"`` subtracts the pad bits, which XNOR to 1 on both sides
    (the reference's correction).  The golden twin of the bank-executed
    dot product.  Runs on ``device``; by default on that of a tensor
    ``x_bits``, else on the card (``device="cpu"`` for the plain
    version)."""
    from ..core.simulator import resolve_device
    if device is None:
        device = (x_bits.device if isinstance(x_bits, torch.Tensor)
                  else "cuda")
    dev = resolve_device(device)
    x = torch.as_tensor(x_bits, device=dev).to(torch.uint8)
    w = torch.as_tensor(w_bits, device=dev).to(torch.uint8)
    pk = (-x.shape[1]) % 32
    xq = pack_bits(torch.nn.functional.pad(x, (0, pk)))
    wq = pack_bits(torch.nn.functional.pad(w, (0, pk)))
    out = popcount_gemm(xq, wq, kind=kind)
    if kind == "xnor" and pk:
        out = out - pk
    return out


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0,
                    scale: float | None = None):
    """Causal / windowed online-softmax attention forward over grouped K/V:
    q (B, Sq, H, hd), k / v (B, Sk, KV, hd), int32 positions (B, Sq) /
    (B, Sk) -> (out (B, Sq, H, hd) in q's type, lse (B, H, Sq) float32);
    scores ``q·k · scale`` (``1/√hd`` unless given).  See
    :mod:`repro_torch.kernels.flash_attention`."""
    return _route(q, _fa.flash_attention_cuda, _fa.flash_attention_plain)(
        q, k, v, q_pos, kv_pos, window=window, softcap=softcap, scale=scale)


def flash_attention_bwd(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                        window: int = 0, softcap: float = 0.0,
                        scale: float | None = None):
    """The attention region's backward by recompute: the forward's inputs,
    its ``out`` and ``lse`` and the cotangent ``dout`` -> (dq (B, Sq, H,
    hd), dk, dv (B, Sk, KV, hd) per kv head).  See
    :mod:`repro_torch.kernels.flash_attention`."""
    return _route(q, _fa.flash_attention_bwd_cuda,
                  _fa.flash_attention_bwd_plain)(
        q, k, v, q_pos, kv_pos, out, lse, dout, window=window,
        softcap=softcap, scale=scale)
