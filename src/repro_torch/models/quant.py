"""Binary (1-bit) linear layers on the popcount GEMM kernel.

The port of ``repro.models.quant``: the end-to-end consumer of the paper's
substrate.  Weights and activations are binarized to {-1, +1} by sign,
bit-packed, and the matmul becomes XNOR + popcount — in DRAM a sequence of
bulk Boolean ops plus the bit-serial popcount tree
(``repro_torch.core.compiler.dot_exprs``), on the card the hand-written
``popcount_gemm`` kernel (``kernels/csrc/popcount_gemm.cu``) through
:func:`repro_torch.kernels.ops.popcount_gemm`.  Training uses the
straight-through estimator (STE).

The reference declares an optional projection mode
(``ModelConfig.quant_proj="binary"``) that no layer reads; the port has no
such switch either.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core.simulator import resolve_device
from ..kernels import ops as kops


def binarize_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (M, K) float -> (packed sign bits (M, ceil(K/32)) int32,
    scale (M, 1)).

    Sign bit 1 for x >= 0 (maps to +1), 0 for x < 0 (maps to -1); scale is
    the mean |x| per row (XNOR-Net style); K is zero-padded to a multiple
    of 32."""
    scale = x.abs().mean(dim=-1, keepdim=True)
    bits = (x >= 0).to(torch.uint8)
    pad = (-x.shape[-1]) % 32
    if pad:
        bits = nn.functional.pad(bits, (0, pad))
    return kops.pack_bits(bits), scale


def binary_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K), w: (N, K) float -> (M, N): sign(x) · sign(w)ᵀ · scales.

    The pad bits (sign bit 0, i.e. -1, on both operands) add +1 each to
    the XNOR dot; they are subtracted exactly."""
    xq, sx = binarize_pack(x)
    wq, sw = binarize_pack(w)
    pad = (-x.shape[-1]) % 32
    dots = kops.popcount_gemm(xq, wq, kind="xnor").to(torch.float32)
    if pad:
        dots = dots - pad
    return dots * sx * sw.T


class _SteBinaryMatmul(torch.autograd.Function):
    """Forward :func:`binary_matmul`; backward the straight-through
    estimator: the gradient of ``x @ wᵀ``, clipped to the binarization
    range ``|·| <= 1`` (plain products; the reference has no backward
    kernel)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return binary_matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (g @ w) * (x.abs() <= 1.0)
        gw = (g.T @ x) * (w.abs() <= 1.0)
        return gx, gw


def ste_binary_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`binary_matmul` with the STE backward."""
    return _SteBinaryMatmul.apply(x, w)


def init_binary_linear(in_dim: int, out_dim: int, *,
                       generator: torch.Generator | None = None,
                       device: str | torch.device = "cuda") -> dict:
    """``{"w": (out_dim, in_dim)}`` float32, normal / sqrt(in_dim)."""
    w = torch.randn((out_dim, in_dim), generator=generator,
                    device=resolve_device(device), dtype=torch.float32)
    return {"w": w / math.sqrt(in_dim)}


def apply_binary_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (..., K) -> (..., N) through the 1-bit path; computes in float32
    and returns ``x``'s dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    y = ste_binary_matmul(x2, p["w"].to(torch.float32))
    return y.reshape(*lead, -1).to(x.dtype)


class BinaryLinear(nn.Module):
    """A bias-free linear layer through the 1-bit path (STE-trainable):
    the module form of :func:`init_binary_linear` /
    :func:`apply_binary_linear`."""

    def __init__(self, in_dim: int, out_dim: int, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        p = init_binary_linear(in_dim, out_dim, generator=generator,
                               device=device)
        self.weight = nn.Parameter(p["w"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_binary_linear({"w": self.weight}, x)

    def extra_repr(self) -> str:
        return f"in_dim={self.in_dim}, out_dim={self.out_dim}"
