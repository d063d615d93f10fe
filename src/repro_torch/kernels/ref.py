"""Plain PyTorch oracles of the reference kernels (``repro.kernels.ref``).

They keep the reference's own formulas and operation order, so the port's
tests can hold them against ``repro.kernels.ref`` exactly.

Packed words are ``int32`` bit patterns: on PyTorch 2.13 ``~`` and ``>>``
raise on ``torch.uint32``.  ``words.numpy().view(np.uint32)`` gives the
reference's uint32 words back.
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# N-ary bitwise ops on packed bit-planes
# ---------------------------------------------------------------------------
def nary_bitwise(op: str, planes: torch.Tensor) -> torch.Tensor:
    """planes: (N, ...) packed int32 -> (...) int32; op in {and, or, nand,
    nor, xor}, reduced plane by plane in index order."""
    n = planes.shape[0]
    if op in ("and", "nand"):
        acc = planes[0]
        for i in range(1, n):
            acc = acc & planes[i]
        return ~acc if op == "nand" else acc
    if op in ("or", "nor"):
        acc = planes[0]
        for i in range(1, n):
            acc = acc | planes[i]
        return ~acc if op == "nor" else acc
    if op == "xor":
        acc = planes[0]
        for i in range(1, n):
            acc = acc ^ planes[i]
        return acc
    raise ValueError(op)


def not_(plane: torch.Tensor) -> torch.Tensor:
    return ~plane


def maj3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Bitwise 3-input majority of packed words."""
    return (a & b) | (c & (a | b))


def bitcount_planes(planes: torch.Tensor) -> torch.Tensor:
    """Per-bit-position popcount across N planes -> bit-sliced counter:
    (N, ...) -> (max(1, N.bit_length()), ...) counter planes, LSB first."""
    n = planes.shape[0]
    k = max(1, n.bit_length())
    slices = [torch.zeros_like(planes[0]) for _ in range(k)]
    for i in range(n):
        carry = planes[i]
        for j in range(k):
            new = slices[j] ^ carry
            carry = slices[j] & carry
            slices[j] = new
    return torch.stack(slices)


def add_planes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K, ...) + (K, ...) packed planes, LSB first -> (K+1, ...):
    ripple carry, the carry plane last."""
    k = a.shape[0]
    outs = []
    carry = torch.zeros_like(a[0])
    for i in range(k):
        s = a[i] ^ b[i] ^ carry
        carry = (a[i] & b[i]) | (carry & (a[i] ^ b[i]))
        outs.append(s)
    outs.append(carry)
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# 1-bit (packed) GEMM: AND / XNOR + popcount
# ---------------------------------------------------------------------------
#: bytes the plain GEMM's (m, N, KB) intermediates may take per M chunk
GEMM_CHUNK_BYTES = 1 << 30


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 bit patterns -> int32 in 0..32.

    SWAR on int32, masked after every ``>>`` (int32 ``>>`` is arithmetic).
    The sign bit is counted apart, so no partial sum leaves the
    non-negative int32 range."""
    y = x & 0x7FFFFFFF
    y = (y & 0x55555555) + ((y >> 1) & 0x55555555)
    y = (y & 0x33333333) + ((y >> 2) & 0x33333333)
    y = (y + (y >> 4)) & 0x0F0F0F0F
    y = y + (y >> 8)
    y = (y + (y >> 16)) & 0x3F
    return y + (x < 0).to(torch.int32)


def popcount_gemm(x: torch.Tensor, w: torch.Tensor,
                  kind: str = "and") -> torch.Tensor:
    """x: (M, KB) int32, w: (N, KB) int32 packed words -> (M, N) int32.

    kind="and":  out[m,n] = sum_b popcount(x[m,b] & w[n,b])
    kind="xnor": out[m,n] = 32·KB - 2 * sum_b popcount(x[m,b] ^ w[n,b])
    Chunked over M so the (m, N, KB) intermediates stay under
    :data:`GEMM_CHUNK_BYTES`."""
    if kind not in ("and", "xnor"):
        raise ValueError(kind)
    m, kb = x.shape
    n = w.shape[0]
    # the masked word, its popcount and two SWAR temporaries are alive
    step = max(1, GEMM_CHUNK_BYTES // max(1, 16 * n * kb))
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    wa = w[None]
    for lo in range(0, m, step):
        xa = x[lo:lo + step, None, :]
        both = xa & wa if kind == "and" else xa ^ wa
        out[lo:lo + step] = popcount32(both).sum(-1, dtype=torch.int32)
    if kind == "xnor":
        out = 32 * kb - 2 * out
    return out


# ---------------------------------------------------------------------------
# Sense-amp Monte-Carlo resolver
# ---------------------------------------------------------------------------

def senseamp_resolve(v_com: torch.Tensor, v_ref: torch.Tensor,
                     static_off: torch.Tensor, noise: torch.Tensor,
                     u_float: torch.Tensor, *, shift: float, pf: float,
                     trial_sigma: float) -> torch.Tensor:
    """Sense-amp decision from charge-shared voltages (reference order):
    ``v_com − v_ref − shift + static + σ·noise > 0``, floor flip
    ``u_float[0] < pf`` replaced by the coin ``u_float[1] < 0.5``.
    -> uint8 per column."""
    margin = v_com - v_ref - shift + static_off + trial_sigma * noise
    out = margin > 0.0
    flip = u_float[0] < pf
    coin = u_float[1] < 0.5
    return torch.where(flip, coin, out).to(torch.uint8)


def senseamp_resolve_trials(com_cells: torch.Tensor, ref_cells: torch.Tensor,
                            static: torch.Tensor, normals: torch.Tensor,
                            uniforms: torch.Tensor, *, u_com: float,
                            u_ref: float, shift: float, pf: float,
                            trial_sigma: float) -> torch.Tensor:
    """Trial-batched oracle: (T, N, W) cell slabs, static (W,) or (T, W),
    normals (T, W), uniforms (2, T, W) -> (T, W) uint8."""
    v_com = torch.sum(com_cells - 0.5, dim=1) * u_com
    v_ref = torch.sum(ref_cells - 0.5, dim=1) * u_ref
    return senseamp_resolve(v_com, v_ref, static, normals, uniforms,
                            shift=shift, pf=pf, trial_sigma=trial_sigma)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., W) {0,1} -> (..., W//32) int32 bit patterns; bit i -> word
    i//32, bit i%32."""
    *lead, w = bits.shape
    if w % 32:
        raise ValueError(f"width must be a multiple of 32, got {w}")
    b = bits.reshape(*lead, w // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., B) int32 bit patterns -> (..., B*32) uint8."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1],
                        words.shape[-1] * 32).to(torch.uint8)
