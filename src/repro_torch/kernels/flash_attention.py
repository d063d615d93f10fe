"""Flash-attention forward over grouped K/V: the Hopper kernel and its
plain twin.

Replaces ``repro/kernels/flash_attention.py::flash_attention``, the Pallas
TPU kernel, and the forward of the reference's ``layers.fused_attention``
region (``_fused_flash_fwd_impl``), whose function it computes: the
kernel's causal / windowed online softmax plus the region's ``softcap``
and ``lse`` output.  ``repro_torch.models.layers.apply_attention`` calls it
(through :func:`repro_torch.kernels.ops.flash_attention`) once per layer,
for prefill, prefill into a cache and decode alike.

Shapes: ``q`` (B, Sq, H, hd); ``k`` / ``v`` (B, Sk, KV, hd) with
``H % KV == 0`` — query head ``h`` reads kv head ``h // (H // KV)``, as the
reference's ``jnp.repeat`` of K/V along the heads implies, but unrepeated;
``q_pos`` (B, Sq) and ``kv_pos`` (B, Sk) int32.  Returns ``out`` (B, Sq, H,
hd) in q's type and ``lse`` (B, H, Sq) float32.  The compute type is q's:
K and V are rounded to it (the reference's ``k_all.astype(cdt)``), scores
and the softmax state are float32, P is rounded to it before P·V.  A key
is visible to a query when ``q_pos >= kv_pos`` (and ``q_pos - kv_pos <
window`` when ``window > 0``); a query that sees no key gives 0, so cache
slots holding ``POS_SENTINEL`` are invisible.

:func:`flash_attention_cuda` launches ``csrc/flash_attention.cu``: one
block per (batch, kv head, 64 flat query rows of that kv head's group),
K/V tiles staged through shared memory and read once per group, tiles no
row can see skipped; ``mma.sync`` bf16 tensor-core products for bf16 q, a
CUDA-core float32 variant for float32 q.  K/V may be float32 or bfloat16
(the serving cache is float32).  :func:`flash_attention_plain` is the same
function in plain PyTorch, mirroring ``_fused_flash_fwd_impl`` (KV chunks
of ``KV_CHUNK``, the same padding sentinel): what a CPU tensor gets and
what the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import math

import torch

#: the reference's KV block of the region's scan (layers.py KV_CHUNK)
KV_CHUNK = 1024
#: kv position of padded keys (jnp.iinfo(jnp.int32).max // 2)
PAD_POS = (2 ** 31 - 1) // 2
#: masked score and initial running max of the reference
NEG = -1e30

#: kernel launches since the counts were last reset (plain calls not
#: counted)
launches = {"flash_attention": 0}

_FLOATS = (torch.float32, torch.bfloat16)


def _check(q, k, v, q_pos, kv_pos) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, H, hd) and k, v (B, Sk, KV, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, sk, kvh, khd = k.shape
    if k.shape[0] != b or khd != hd or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (same B and hd, H a multiple of KV)")
    if sk == 0:
        raise ValueError("no keys (Sk = 0)")
    if tuple(q_pos.shape) != (b, sq) or tuple(kv_pos.shape) != (b, sk):
        raise ValueError(f"positions {tuple(q_pos.shape)}, "
                         f"{tuple(kv_pos.shape)} do not fit ({b}, {sq}) and "
                         f"({b}, {sk})")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise ValueError("positions must be int32")
    if q.dtype not in _FLOATS or k.dtype not in _FLOATS or v.dtype != k.dtype:
        raise ValueError(f"q must be float32 or bfloat16 and k, v one of "
                         f"those alike; got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, window: int = 0,
                          softcap: float = 0.0):
    """Plain twin: -> (out (B, Sq, H, hd) in q's type, lse (B, H, Sq))."""
    _check(q, k, v, q_pos, kv_pos)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    cdt = q.dtype
    scale = 1.0 / math.sqrt(hd)
    chunk = min(KV_CHUNK, sk)
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    # the cache's values at the compute type, then exact float32 products
    # (the reference's preferred_element_type=float32)
    k, v = k.to(cdt), v.to(cdt)
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=PAD_POS)
    qf = q.float().reshape(b, sq, kvh, grp, hd)
    qp = q_pos[:, None, None, :, None]
    m = torch.full((b, kvh, grp, sq), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, grp, sq, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_i, v_i = k[:, sl].float(), v[:, sl]
        p_i = kv_pos[:, None, None, None, sl]
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, k_i) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        keep = qp >= p_i
        if window > 0:
            keep &= qp - p_i < window
        s = torch.where(keep, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(keep, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p.to(v_i.dtype).float(), v_i.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    lse = m + torch.log(torch.clamp(l, min=1e-20))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
    return out, lse.reshape(b, h, sq)


_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from . import build
    lib = build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = [_VP] * 7 + [_INT] * 7 + [
            _F, _F, _INT, _INT, _VP]
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q, k, v, q_pos, kv_pos, *, window: int = 0,
                         softcap: float = 0.0):
    """Launch the kernel on the current stream; -> (out, lse) as
    :func:`flash_attention_plain`.  Anything the kernel does not take
    raises: hd must be a multiple of 8 up to 128."""
    _check(q, k, v, q_pos, kv_pos)
    ts = {"q": q, "k": k, "v": v, "q_pos": q_pos, "kv_pos": kv_pos}
    for name, t in ts.items():
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous CUDA tensor, got "
                             f"one on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte aligned rows")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if hd % 8 or hd > 128:
        raise ValueError(f"hd = {hd}: the kernel takes multiples of 8 up to "
                         f"128")
    if b > 65535 or kvh > 65535:
        raise ValueError(f"B = {b}, KV = {kvh} exceed the kernel's grid")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0:        # nothing to launch
        return out, lse
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, sk, h,
            kvh, hd, int(window), 1.0 / math.sqrt(hd), float(softcap),
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    launches["flash_attention"] += 1
    return out, lse
