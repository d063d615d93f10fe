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
hd) in q's type and ``lse`` (B, H, Sq) float32.  Scores are ``q·k ·
scale``, ``scale`` ``1/√hd`` unless given (Granite 4.0-H's
``attention_multiplier``).  The compute type is q's:
K and V are rounded to it (the reference's ``k_all.astype(cdt)``), scores
and the softmax state are float32, P is rounded to it before P·V.  A key
is visible to a query when ``q_pos >= kv_pos`` (and ``q_pos - kv_pos <
window`` when ``window > 0``); a query that sees no key gives 0, so cache
slots holding ``POS_SENTINEL`` are invisible.

:func:`flash_attention_cuda` launches ``csrc/flash_attention.cu``: one
block per (batch, kv head, flat query rows of that kv head's group), K/V
tiles brought into a shared-memory ring by ``cp.async`` ahead of the
products, rounded to q's type and read once per group, tiles no row can
see skipped.  bf16 q: at hd 64 / 80, 192-row blocks of three warpgroups
on ``wgmma`` (swizzled shared-memory operands, P from registers); otherwise
``mma.sync``.  float32 q: a CUDA-core variant.  K/V may be float32 or
bfloat16 (the serving cache is float32).  A call whose rows fit one
64-row block (decode) and whose ``B * KV`` blocks would leave the card
idle splits the keys (:func:`split_plan`): each split writes float32
partials ``(m, l, acc)`` and a second kernel merges them, launched from
the same host call (alone: :func:`combine_cuda`).
:func:`flash_attention_plain` is the same function in plain PyTorch,
mirroring ``_fused_flash_fwd_impl`` (KV chunks of ``KV_CHUNK``, the same
padding sentinel): what a CPU tensor gets and what the kernel is held
against on the card, within :func:`bf16_out_tolerance` at bf16;
:func:`split_partials_plain` and :func:`combine_plain` are the split
path's twins.

The backward of the region (``_fused_flash_bwd_impl``, behind the
reference's ``custom_vjp``) is :func:`flash_attention_bwd_cuda`, which
launches ``csrc/flash_attention_bwd.cu``: from q, k, v, the positions, the
forward's ``out`` and ``lse`` and ``dout`` it gives ``dq`` (B, Sq, H, hd)
and ``dk`` / ``dv`` (B, Sk, KV, hd) per kv head — the reference's
per-query-head ``dk`` / ``dv`` summed over each group, the transpose of its
``jnp.repeat`` of K/V.  Three kernels in one host call: ``delta =
rowsum(dout * out)``, then one block per (batch, kv head, 64 keys) walking
the query tiles of all the group's heads for ``dk`` / ``dv``, and one per
(batch, query head, 64 queries) walking the key tiles for ``dq``; no
floating-point atomics, so two runs give bit-identical gradients.  bf16 on
``mma.sync``, float32 on the CUDA cores.  :func:`flash_attention_bwd_plain`
is its plain twin, a chunked transcription of ``_fused_flash_bwd_impl``
over the repeated heads followed by the group sum.
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

#: keys per tile of the bf16 kernel: the split path's unit
TILE_KEYS = 64
#: rows (Sq * H / KV) of one block of the split path
SPLIT_ROWS = 64
#: blocks per SM the split aims at (at most two are resident at once: the
#: rest cover the slots' unequal lengths)
SPLIT_BLOCKS_PER_SM = 4

#: kernel launches since the counts were last reset (plain calls not
#: counted); ``flash_attention`` counts calls, ``flash_attention_combine``
#: the merges of the split ones, ``flash_attention_bwd`` backward calls
#: (three device kernels each)
launches = {"flash_attention": 0, "flash_attention_combine": 0,
            "flash_attention_bwd": 0}

_FLOATS = (torch.float32, torch.bfloat16)


def _check(q, k, v, q_pos, kv_pos, f64: bool = False) -> None:
    """Raise on what the function does not take; ``f64`` also lets q, k
    and v be float64 all three (the plain twins' float64 evaluation)."""
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
    all64 = f64 and q.dtype == k.dtype == v.dtype == torch.float64
    if not all64 and (q.dtype not in _FLOATS or k.dtype not in _FLOATS
                      or v.dtype != k.dtype):
        raise ValueError(f"q must be float32 or bfloat16 and k, v one of "
                         f"those alike; got {q.dtype}, {k.dtype}, {v.dtype}")


def _partials_plain(q, k, v, q_pos, kv_pos, window, softcap,
                    extra_mask=None, scale=None):
    """The online softmax over every key: -> float32 (float64 inputs:
    float64) m, l (B, KV, G, Sq) and acc (B, KV, G, Sq, hd),
    unnormalized.  ``extra_mask`` (B, Sq, Sk) bool, True = attend: the
    reference's unfused path (``_flash_attend_inner``), which keeps P in
    float32 where the fused region rounds it to V's type."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    cdt = q.dtype
    # float32 sums (float64 for float64 inputs)
    adt = torch.float64 if cdt == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
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
        if extra_mask is not None:
            extra_mask = torch.nn.functional.pad(extra_mask, (0, pad))
    qf = q.to(adt).reshape(b, sq, kvh, grp, hd)
    qp = q_pos[:, None, None, :, None]
    m = torch.full((b, kvh, grp, sq), NEG, dtype=adt, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, grp, sq, hd), dtype=adt, device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_i, v_i = k[:, sl].to(adt), v[:, sl]
        p_i = kv_pos[:, None, None, None, sl]
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, k_i) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        keep = qp >= p_i
        if window > 0:
            keep &= qp - p_i < window
        if extra_mask is not None:
            keep &= extra_mask[:, None, None, :, sl]
        s = torch.where(keep, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(keep, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        if extra_mask is None:
            p = p.to(v_i.dtype).to(adt)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p, v_i.to(adt))
        m = m_new
    return m, l, acc


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, window: int = 0,
                          softcap: float = 0.0, extra_mask=None,
                          scale: float | None = None):
    """Plain twin: -> (out (B, Sq, H, hd) in q's type, lse (B, H, Sq)),
    float32 (float64 for float64 inputs).  With ``extra_mask`` (B, Sq,
    Sk) it is the reference's unfused path, which the kernel does not
    take (:func:`_partials_plain`)."""
    _check(q, k, v, q_pos, kv_pos, f64=True)
    b, sq, h, hd = q.shape
    m, l, acc = _partials_plain(q, k, v, q_pos, kv_pos, window, softcap,
                                extra_mask, scale)
    out = acc / torch.clamp(l[..., None], min=1e-20)
    lse = m + torch.log(torch.clamp(l, min=1e-20))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
    return out, lse.reshape(b, h, sq)


def bf16_out_tolerance(q, k, v, q_pos, kv_pos, want, *, window: int = 0,
                       softcap: float = 0.0) -> torch.Tensor:
    """How far a bf16 ``out`` may lie from the plain version's ``want =
    (out, lse)`` on these inputs, per element: ``1e-3 + 2^-6 |out| + 2^-5
    sqrt(sum_j p_j^2 v_j^2) / l``, the sum over the row's visible keys
    (p_j = e^(s_j - m), l = sum_j p_j; K and V at bf16).

    The second term is out's own rounding (one bf16 ulp is at most 2^-7
    |out|).  The third is P's: rounded to bf16 at another running max
    (another tile or split), each p_j moves by at most one ulp, 2^-7 p_j,
    so out moves by at most 2^-7 p_j |v_j| / l for one key — a quarter of
    the term — and by a sum whose standard deviation is at most 2^-7 / √6
    of the root (a tenth of the term) when many keys move.  The root is
    one more plain pass: scores doubled (2 q, softcap doubled) give
    weights p_j^2, summing v^2, with lse2 = 2 m + log sum p_j^2."""
    out, lse = want
    kb, vb = k.to(q.dtype).float(), v.to(q.dtype).float()
    out2, lse2 = flash_attention_plain(2 * q.float(), kb, vb * vb, q_pos,
                                       kv_pos, window=window,
                                       softcap=2 * softcap)
    ratio = torch.exp(torch.clamp(lse2 - 2 * lse, max=0.0))   # sum p^2 / l^2
    root = torch.sqrt(out2 * ratio.transpose(1, 2)[..., None])
    return 1e-3 + 2.0 ** -6 * out.float().abs() + 2.0 ** -5 * root


def decode_splits(b: int, kvh: int, sk: int, sm_count: int
                  ) -> tuple[int, int]:
    """How the split path cuts the keys of a call with ``b * kvh`` blocks:
    -> (n_split, split_tiles).  Split i covers tiles ``[i * split_tiles,
    (i + 1) * split_tiles)`` of ``TILE_KEYS`` keys (the last one ends at
    Sk), so every tile lies in exactly one split and none is empty; the
    count aims at ``SPLIT_BLOCKS_PER_SM`` blocks per SM.  ``(1, tiles)``
    when ``b * kvh`` blocks already fill the card."""
    tiles = -(-sk // TILE_KEYS)
    want = -(-SPLIT_BLOCKS_PER_SM * sm_count // max(1, b * kvh))
    n = max(1, min(tiles, want))
    per = -(-tiles // n)
    return -(-tiles // per), per


def split_plan(b: int, sq: int, h: int, kvh: int, sk: int,
               sm_count: int) -> tuple[int, int]:
    """How :func:`flash_attention_cuda` cuts the keys of a call: ->
    (n_split, split_tiles).  A call whose rows fit one ``SPLIT_ROWS``
    block (``Sq * H / KV``: decode, short chunks) takes
    :func:`decode_splits`; any other walks every tile in one range,
    ``(1, tiles)``."""
    if sq * (h // kvh) <= SPLIT_ROWS:
        return decode_splits(b, kvh, sk, sm_count)
    return 1, -(-sk // TILE_KEYS)


def split_ranges(sk: int, n_split: int, split_tiles: int
                 ) -> list[tuple[int, int]]:
    """The key ranges ``[lo, hi)`` of the splits; raises unless each is
    non-empty and together they cover the Sk keys."""
    step = split_tiles * TILE_KEYS
    if n_split < 1 or split_tiles < 1 or not (
            (n_split - 1) * step < sk <= n_split * step):
        raise ValueError(f"{n_split} splits of {split_tiles} tiles do not "
                         f"cut {sk} keys into non-empty ranges")
    return [(i * step, min(sk, (i + 1) * step)) for i in range(n_split)]


def split_partials_plain(q, k, v, q_pos, kv_pos, *, n_split: int,
                         split_tiles: int, window: int = 0,
                         softcap: float = 0.0):
    """Plain twin of the split kernel: -> float32 partials ``part_acc``
    (n_split, B, Sq, H, hd), unnormalized, and ``part_ml`` (n_split, B,
    H, Sq, 2) of (m, l), each split over its own keys.  A split that sees
    nothing gives m = -1e30, l = 0, acc = 0."""
    _check(q, k, v, q_pos, kv_pos)
    b, sq, h, hd = q.shape
    accs, mls = [], []
    for lo, hi in split_ranges(k.shape[1], n_split, split_tiles):
        m, l, acc = _partials_plain(q, k[:, lo:hi], v[:, lo:hi], q_pos,
                                    kv_pos[:, lo:hi], window, softcap)
        accs.append(acc.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd))
        mls.append(torch.stack([m, l], -1).reshape(b, h, sq, 2))
    return torch.stack(accs), torch.stack(mls)


def combine_plain(part_acc, part_ml, dtype):
    """Plain twin of the merge: partials -> (out (B, Sq, H, hd) in
    ``dtype``, lse (B, H, Sq)); M = max m_i, L = sum l_i e^(m_i - M),
    acc = sum acc_i e^(m_i - M)."""
    m, l = part_ml[..., 0], part_ml[..., 1]                # (n, B, H, Sq)
    big = m.amax(0)
    wt = torch.exp(m - big)
    el = (l * wt).sum(0)
    acc = (part_acc * wt.transpose(2, 3)[..., None]).sum(0)
    out = acc / torch.clamp(el.transpose(1, 2)[..., None], min=1e-20)
    return out.to(dtype), big + torch.log(torch.clamp(el, min=1e-20))


def flash_attention_split_plain(q, k, v, q_pos, kv_pos, *, n_split: int,
                                split_tiles: int, window: int = 0,
                                softcap: float = 0.0):
    """The split path in plain PyTorch: partials, then the merge."""
    parts = split_partials_plain(q, k, v, q_pos, kv_pos, n_split=n_split,
                                 split_tiles=split_tiles, window=window,
                                 softcap=softcap)
    return combine_plain(*parts, q.dtype)


_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import build
        lib = build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = [_VP] * 9 + [_INT] * 9 + [
            _F, _F, _INT, _INT, _INT, _VP]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_combine.argtypes = [_VP] * 4 + [_INT] * 7 + [_VP]
        lib.flash_attention_combine.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _stream(idx: int) -> int:
    """The raw handle of the device's current stream (PyTorch's own cheap
    accessor where the build has it)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(idx) if raw is not None else \
        torch.cuda.current_stream(idx).cuda_stream


def _want_cuda(**ts) -> None:
    first = next(iter(ts.values()))
    for name, t in ts.items():
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous CUDA tensor, got "
                             f"one on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
        if t.device != first.device:
            raise ValueError(f"{name} on {t.device}, {next(iter(ts))} on "
                             f"{first.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte aligned rows")


#: per call signature (shapes, types, devices): what :func:`_plan` found
_PLANS: dict[tuple, tuple] = {}


def _plan(q, k, v, q_pos, kv_pos) -> tuple:
    """Check a call signature once: -> (device, device index, lse shape,
    n_split, split_tiles, partial floats of acc, of all partials)."""
    _check(q, k, v, q_pos, kv_pos)
    _want_cuda(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if hd % 8 or hd > 128:
        raise ValueError(f"hd = {hd}: the kernel takes multiples of 8 up to "
                         f"128")
    if b > 65535 or kvh > 65535:
        raise ValueError(f"B = {b}, KV = {kvh} exceed the kernel's grid")
    n, per = split_plan(b, sq, h, kvh, sk, sm_count(q.device))
    acc = n * b * sq * h * hd if n > 1 else 0
    return (q.device, q.get_device(), (b, h, sq), n, per, acc,
            acc + 2 * n * b * h * sq if n > 1 else 0)


def flash_attention_cuda(q, k, v, q_pos, kv_pos, *, window: int = 0,
                         softcap: float = 0.0, scale: float | None = None):
    """Launch the kernel on the current stream (and, on the split path, the
    merge, from the same host call); -> (out, lse) as
    :func:`flash_attention_plain`.  Anything the kernel does not take
    raises: hd must be a multiple of 8 up to 128.  Shapes, types and the
    split are checked once per call signature; contiguity and alignment on
    every call."""
    key = (q.shape, k.shape, v.shape, q_pos.shape, kv_pos.shape, q.dtype,
           k.dtype, v.dtype, q_pos.dtype, kv_pos.dtype, q.get_device(),
           k.get_device(), v.get_device(), q_pos.get_device(),
           kv_pos.get_device())
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= 4096:
            _PLANS.clear()
        plan = _PLANS[key] = _plan(q, k, v, q_pos, kv_pos)
    dev, idx, lse_shape, n, per, n_acc, n_part = plan
    for t in (q, k, v, q_pos, kv_pos):
        if not t.is_contiguous() or t.data_ptr() % 16:
            _want_cuda(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(lse_shape, dtype=torch.float32, device=dev)
    if b == 0 or sq == 0:        # nothing to launch
        return out, lse
    part = acc_ptr = ml_ptr = None
    if n > 1:       # one buffer: acc (n, B, Sq, H, hd), ml (n, B, H, Sq, 2)
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
        acc_ptr = part.data_ptr()
        ml_ptr = acc_ptr + 4 * n_acc
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(), lse.data_ptr(), acc_ptr, ml_ptr,
        b, sq, k.shape[1], h, k.shape[2], hd, int(window), n, per,
        1.0 / math.sqrt(hd) if scale is None else float(scale),
        float(softcap), int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), idx, _stream(idx))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    launches["flash_attention"] += 1
    if n > 1:
        launches["flash_attention_combine"] += 1
    return out, lse


def combine_cuda(part_acc, part_ml, dtype):
    """Launch the merge alone on partials laid out as
    :func:`split_partials_plain` gives them; -> (out, lse) as
    :func:`combine_plain`."""
    _want_cuda(part_acc=part_acc, part_ml=part_ml)
    if (part_acc.dim() != 5 or part_acc.dtype != torch.float32
            or part_ml.dtype != torch.float32
            or part_ml.shape != (*part_acc.shape[:2], part_acc.shape[3],
                                 part_acc.shape[2], 2)):
        raise ValueError(f"want float32 part_acc (n, B, Sq, H, hd) and "
                         f"part_ml (n, B, H, Sq, 2); got "
                         f"{tuple(part_acc.shape)}, {tuple(part_ml.shape)}")
    if dtype not in _FLOATS or part_acc.shape[-1] > 128:
        raise ValueError(f"out dtype {dtype}, hd {part_acc.shape[-1]}: want "
                         f"float32 / bfloat16 and hd <= 128")
    n, b, sq, h, hd = part_acc.shape
    out = torch.empty((b, sq, h, hd), dtype=dtype, device=part_acc.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=out.device)
    idx = out.get_device()
    err = _lib().flash_attention_combine(
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        lse.data_ptr(), n, b, sq, h, hd, int(dtype == torch.bfloat16), idx,
        _stream(idx))
    if err != 0:
        raise RuntimeError(f"flash_attention_combine launch failed: CUDA "
                           f"error {err}")
    launches["flash_attention_combine"] += 1
    return out, lse


# ---------------------------------------------------------------------------
# Backward of the region
# ---------------------------------------------------------------------------
def _check_bwd(q, out, lse, dout) -> None:
    b, sq, h, _hd = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse {tuple(lse.shape)} is not (B, H, Sq) = "
                         f"{(b, h, sq)}")


def flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                              window: int = 0, softcap: float = 0.0,
                              scale: float | None = None):
    """Plain twin of the backward: -> (dq in q's type, dk in k's, dv in
    v's), a chunked transcription of the reference's
    ``_fused_flash_bwd_impl`` (KV chunks of ``KV_CHUNK``, padded keys at
    ``PAD_POS``) over K/V repeated to the H query heads, followed by the
    group sum of dk / dv in float32.  The compute type is q's (K and V
    rounded to it); p and ds are rounded to it before their products and
    each query head's dk / dv after; products and sums run in float32
    (float64 for float64 inputs, which makes this the float64 evaluation
    the bf16 kernel's tolerance is measured from).  ``delta =
    sum((dout * out) in float32)`` takes the product at the activation
    type first, as the reference does."""
    _check(q, k, v, q_pos, kv_pos, f64=True)
    _check_bwd(q, out, lse, dout)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    cdt = q.dtype
    acc = torch.float64 if cdt == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    chunk = min(KV_CHUNK, sk)
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    kr = k.to(cdt).repeat_interleave(grp, dim=2)
    vr = v.to(cdt).repeat_interleave(grp, dim=2)
    if pad:
        kr = torch.nn.functional.pad(kr, (0, 0, 0, 0, 0, pad))
        vr = torch.nn.functional.pad(vr, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=PAD_POS)
    qa = q.to(acc)
    do = dout.to(cdt).permute(0, 2, 1, 3).to(acc)             # (B, H, Sq, hd)
    delta = (dout * out).to(acc).sum(-1).permute(0, 2, 1)      # (B, H, Sq)
    lse = lse.to(acc)
    qp = q_pos[:, None, :, None]
    dq = torch.zeros((b, sq, h, hd), dtype=acc, device=q.device)
    dks, dvs = [], []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_i, v_i = kr[:, sl].to(acc), vr[:, sl].to(acc)
        p_i = kv_pos[:, None, None, sl]
        s = torch.einsum("bqhd,bkhd->bhqk", qa, k_i) * scale
        if softcap > 0.0:
            t = torch.tanh(s / softcap)
            s = softcap * t
        keep = qp >= p_i
        if window > 0:
            keep &= qp - p_i < window
        p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
        dvs.append(torch.einsum("bhqk,bhqd->bkhd", p.to(cdt).to(acc), do)
                   .to(cdt))
        dp = torch.einsum("bhqd,bkhd->bhqk", do, v_i)
        ds = p * (dp - delta[..., None])
        if softcap > 0.0:
            ds = ds * (1.0 - t * t)
        ds = ds.to(cdt).to(acc)
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, k_i) * scale
        dks.append((torch.einsum("bhqk,bqhd->bkhd", ds, qa) * scale)
                   .to(cdt))
    # the transpose of the repeat: each kv head sums its group's heads
    dk = torch.cat(dks, 1)[:, :sk].to(acc).reshape(b, sk, kvh, grp, hd)
    dv = torch.cat(dvs, 1)[:, :sk].to(acc).reshape(b, sk, kvh, grp, hd)
    return (dq.to(q.dtype), dk.sum(3).to(k.dtype), dv.sum(3).to(v.dtype))


def grad_excess(got, plain, exact, mult: float = 2.0) -> float:
    """How far a bf16 gradient lies from a float64 evaluation, against the
    bf16 plain twin's own error: ``max |got - exact| / (mult * max |plain -
    exact|)`` (at most 1 passes), elementwise against the twin's worst
    element.  Both round the same float32 sums to bf16 at the same places
    (p and ds before their products, the result once), in other orders;
    their errors are of one size, and ``mult = 2`` leaves room for the
    other order.  A wrong tile or a dropped product would be many times
    the twin's error."""
    e_plain = float((plain.double() - exact.double()).abs().max())
    e_got = float((got.double() - exact.double()).abs().max())
    return e_got / max(mult * e_plain, 1e-30)


_BWD_LIB = None


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the backward library's C signatures on ``lib``."""
    lib.flash_attention_bwd.argtypes = [_VP] * 12 + [_INT] * 7 + [
        _F, _F, _INT, _INT, _VP]
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_workspace.argtypes = [_INT] * 7
    lib.flash_attention_bwd_workspace.restype = ctypes.c_longlong
    return lib


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        from . import build
        _BWD_LIB = bind_bwd(build.load("flash_attention_bwd"))
    return _BWD_LIB


def flash_attention_bwd_cuda(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                             window: int = 0, softcap: float = 0.0,
                             scale: float | None = None):
    """Launch the backward (one host call: ``bwd_prep`` and the one-pass
    ``bwd_wg`` for bf16 at hd > 32, else three kernels) on the current
    stream; -> (dq, dk, dv) as :func:`flash_attention_bwd_plain`.  q, k, v,
    out and dout must share one type (bf16 or float32), lse is float32, hd
    a multiple of 8 up to 128; anything else raises.  The float32
    workspace (the kernel sizes it: delta, or at bf16 the dQ sums
    ``(B, H, Sq, hd)`` padded to whole tiles, their counters and the tile
    ranges) is allocated here, per call."""
    _check(q, k, v, q_pos, kv_pos)
    _check_bwd(q, out, lse, dout)
    if len({q.dtype, k.dtype, v.dtype, out.dtype, dout.dtype}) != 1 \
            or lse.dtype != torch.float32:
        raise ValueError(f"want q, k, v, out, dout of one type and float32 "
                         f"lse; got {q.dtype}, {k.dtype}, {v.dtype}, "
                         f"{out.dtype}, {dout.dtype}, {lse.dtype}")
    _want_cuda(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos, out=out, lse=lse,
               dout=dout)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if hd % 8 or hd > 128:
        raise ValueError(f"hd = {hd}: the kernel takes multiples of 8 up to "
                         f"128")
    if b > 65535 or h > 65535:
        raise ValueError(f"B = {b}, H = {h} exceed the kernel's grid")
    if b * sq * h == 0:                  # no query: no gradient anywhere
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib, bf16 = _bwd_lib(), int(q.dtype == torch.bfloat16)
    work = torch.empty(lib.flash_attention_bwd_workspace(b, sq, sk, h, kvh,
                                                         hd, bf16),
                       dtype=torch.float32, device=q.device)
    idx = q.get_device()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        work.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq,
        sk, h, kvh, hd, int(window),
        1.0 / math.sqrt(hd) if scale is None else float(scale),
        float(softcap), bf16, idx, _stream(idx))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv
