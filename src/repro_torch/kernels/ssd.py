"""The Mamba-2 mixer between the in-projection's split and the
out-projection, its chunked path (prefill, training) and its recurrent step
(decode): the Hopper kernels (CUDA C++, ``csrc/ssd.cu``) and the plain
versions.

Replaces no TPU kernel: the reference's SSD (``repro.models.ssm``) is plain
jnp.  The plain version (:func:`ssd_mixer_plain`, the same functions in
PyTorch operations) builds ``(chunks, heads, Q, Q)`` float32 tensors in
device memory in ~130 eager operations a layer; :func:`ssd_mixer_cuda`
makes five launches, with the ``Q × Q`` products only in shared memory:

1. the causal depthwise conv and SiLU of ``[x, B, C]`` (rounded to the
   compute type term by term, as the plain version), ``dt = softplus(dt_raw
   + dt_bias)`` masked by ``valid``, its running ``dt·A`` within each chunk,
   and the conv window of the last ``kw − 1`` valid inputs into the cache;
2. each chunk's state ``Bᵀ (x · dt · exp(cs_last − cs))``;
3. the recurrence over chunks (each chunk's previous state; the final state
   into the cache);
4. the output of a 128-row tile: ``C Bᵀ`` once for the tile and every head
   of its group in it, ``C · prev · exp(cs_i)`` plus ``(C Bᵀ ⊙ L)(x · dt)``,
   ``+ D·x``, rounded;
5. ``y · silu(z)``, rounded, then the RMSNorm over each of the G slices,
   times the norm's scale.

The SSD runs in float32 on the CUDA cores (no TF32), its products summed in
another order than the plain version's.  Scratch (the activated
``[x, B, C]``, dt, the running sums and the ``(B, NC, NH, N, 64)`` chunk
states) is allocated here.  Shapes: head dim 64, state 16 or 128, chunk 128
or 256, conv width 4, a group's slice of d_inner at most 8,192 wide
(Nemotron 3 Nano, mamba2-780m, hymba-1.5b, Granite 4.0-H's one group of 128
heads); the wrapper raises on others.

:func:`ssd_mixer` dispatches: the kernels for a CUDA tensor where autograd
does not record, the plain version on the CPU and wherever it records (the
kernels have no backward); it counts ``ssm.scan_kernel`` or
``ssm.scan_plain`` in the open trace record, inside an ``ssm.scan`` span.

The recurrent step (a cache, one token a row, no ``"rows"``):
:func:`ssd_step_plain` is the mixer's decode branch in PyTorch operations
(~38 kernels a layer, nine passes over the float32 ``(B, NH, N, HD)``
state); :func:`ssd_step_cuda` makes three launches — dt and the conv into
scratch with the window shifted in the cache; the state update in float32,
read once and written once in place, with ``y = C·state + D·x``; the
chunked path's gated norm — and allocates no state-sized temporary.  The
state's products and sum round as the plain step's; ``y``'s sum over N is
taken in another order.  Shapes: as the chunked path's, without the chunk.
:func:`ssd_step` dispatches by the same rule and counts ``ssm.step_kernel``
or ``ssm.step_plain`` (no span: a CUDA graph replays the step).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import trace
from .flash_attention import _stream

#: kernel launches since the counts were last reset (5 a chunked mixer
#: call, 3 a recurrent step)
launches = {"ssd": 0, "ssd_step": 0}
#: launches of one :func:`ssd_mixer_cuda` call
KERNELS = 5
#: launches of one :func:`ssd_step_cuda` call
STEP_KERNELS = 3
HEAD_DIM = 64
STATES = (16, 128)
CHUNKS = (128, 256)
CONV = 4
#: the widest group's slice of d_inner the norm takes (16 warps x 32 x 16)
GROUP_WIDTH = 8192
#: the mixer's parameters besides the projections
KEYS = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip")

_LIB = None


def _records(p: dict, proj: torch.Tensor) -> bool:
    """Autograd records this call: grad mode on and an input requiring
    grad."""
    return torch.is_grad_enabled() and (
        proj.requires_grad or p["norm"]["scale"].requires_grad
        or any(p[k].requires_grad for k in KEYS))


def ssd_mixer(p: dict, cfg, proj: torch.Tensor, cache: dict | None,
              valid: torch.Tensor | None) -> torch.Tensor:
    """(B, S, 2di + 2·G·N + NH) -> the gated-normed (B, S, di) in proj's
    type; the cache, if any, written in place (at its ``"rows"``, if
    given).  The kernels on a CUDA tensor without autograd recording, the
    plain version otherwise."""
    kernel = proj.is_cuda and not _records(p, proj)
    trace.count("ssm.scan_kernel" if kernel else "ssm.scan_plain")
    with trace.span("ssm.scan"):
        if kernel:
            return ssd_mixer_cuda(p, cfg, proj, cache, valid)
        return ssd_mixer_plain(p, cfg, proj, cache, valid)


def ssd_step(p: dict, cfg, proj: torch.Tensor, cache: dict,
             valid: torch.Tensor | None) -> torch.Tensor:
    """(B, 1, 2di + 2·G·N + NH) -> the gated-normed (B, 1, di) in proj's
    type; the cache's state and conv window advanced one step in place.
    The kernels on a CUDA tensor without autograd recording, the plain
    step otherwise."""
    kernel = proj.is_cuda and not _records(p, proj)
    trace.count("ssm.step_kernel" if kernel else "ssm.step_plain")
    if kernel:
        return ssd_step_cuda(p, cfg, proj, cache, valid)
    return ssd_step_plain(p, cfg, proj, cache, valid)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------
def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular cumulative log products:
    out[i, j] = sum_{k=j+1..i} log_a[k] for i >= j, -inf otherwise."""
    q = log_a.shape[-1]
    csum = torch.cumsum(log_a, -1)
    diff = csum[..., :, None] - csum[..., None, :]
    i = torch.arange(q, device=log_a.device)
    return torch.where(i[:, None] >= i[None, :], diff, -math.inf)


def _ssd_chunked(x, dtv, a_log, bm, cm, chunk: int):
    """SSD over chunks.

    x (B, S, NH, HD) inputs (conv'd and activated), dtv (B, S, NH) the
    softplus'd step, a_log (NH,), bm / cm (B, S, G, N) the state's input
    and output projections, head ``h`` reading group ``h // (NH / G)``
    ((B, S, N): one group).  -> (y (B, S, NH, HD), the final state (B, NH,
    N, HD))."""
    if bm.dim() == 3:
        bm, cm = bm[:, :, None], cm[:, :, None]
    b, s, nh, hd = x.shape
    g, n = bm.shape[-2:]
    hg = nh // g
    q = min(chunk, s)
    assert s % q == 0, f"seq {s} must be divisible by chunk {q}"
    nc = s // q

    dta = dtv * -torch.exp(a_log)                         # (B,S,NH) log decay
    xr = x.reshape(b, nc, q, nh, hd)
    dtr = dtv.reshape(b, nc, q, nh)
    dar = dta.reshape(b, nc, q, nh)
    br = bm.reshape(b, nc, q, g, n).permute(0, 1, 3, 2, 4)   # (B,NC,G,Q,N)
    cr = cm.reshape(b, nc, q, g, n).permute(0, 1, 3, 2, 4)

    # ---- within a chunk (the quadratic dual form) ----
    l = torch.exp(_segsum(dar.permute(0, 1, 3, 2)))      # (B,NC,NH,Q,Q)
    scores = cr @ br.transpose(-1, -2)                    # (B,NC,G,Q,Q)
    m = (scores[:, :, :, None] * l.reshape(b, nc, g, hg, q, q)) \
        .reshape(b, nc, nh, q, q)                         # (B,NC,NH,Q,Q)
    xdt = (xr * dtr[..., None]).permute(0, 1, 3, 2, 4)    # (B,NC,NH,Q,HD)
    y_intra = (m @ xdt).permute(0, 1, 3, 2, 4)            # (B,NC,Q,NH,HD)

    # ---- each chunk's state ----
    csum = torch.cumsum(dar, 2)                           # (B,NC,Q,NH)
    decay_to_end = torch.exp(csum[:, :, -1:] - csum)
    xw = xr * (dtr * decay_to_end)[..., None]             # (B,NC,Q,NH,HD)
    xw = xw.reshape(b, nc, q, g, hg * hd).permute(0, 1, 3, 2, 4)
    states = (br.transpose(-1, -2) @ xw) \
        .reshape(b, nc, g, n, hg, hd).permute(0, 1, 2, 4, 3, 5) \
        .reshape(b, nc, nh, n, hd)                        # (B,NC,NH,N,HD)

    # ---- the recurrence between chunks, emitting the previous state ----
    chunk_decay = torch.exp(dar.sum(2))                   # (B,NC,NH)
    state = torch.zeros((b, nh, n, hd), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                    # (B,NC,NH,N,HD)

    # ---- the previous chunks' output ----
    prev_g = prev_states.to(cr.dtype).reshape(b, nc, g, hg, n, hd) \
        .permute(0, 1, 2, 4, 3, 5).reshape(b, nc, g, n, hg * hd)
    y_inter = (cr @ prev_g).permute(0, 1, 3, 2, 4).reshape(b, nc, q, nh, hd) \
        * torch.exp(csum)[..., None]
    return (y_intra + y_inter).reshape(b, s, nh, hd), state


def gated_norm(p: dict, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    """The block's tail: ``y + D·x`` (float32) rounded to z's type, times
    ``silu(z)``, RMS-normed over each of ``groups`` slices of d_inner
    (Mamba-2's norm before the output projection), times the norm's
    scale, in z's type.  y, xh (B, S, NH, HD)."""
    b, s, nh, hd = xh.shape
    di = nh * hd
    y = y + p["d_skip"][:, None] * xh.float()
    y = y.reshape(b, s, di).to(z.dtype)
    yz = (y * F.silu(z)).float().reshape(b, s, groups, di // groups)
    var = yz.square().mean(-1, keepdim=True)
    yn = (yz * torch.rsqrt(var + eps)).reshape(b, s, di)
    return (yn * p["norm"]["scale"].float()).to(z.dtype)


def write_rows(cache: torch.Tensor, rows: torch.Tensor | None,
               new: torch.Tensor) -> None:
    """``new`` into the cache in place: every row, or the batch rows
    ``rows`` of a larger cache."""
    if rows is None:
        cache.copy_(new)
    else:
        cache.index_copy_(0, rows, new.to(cache.dtype))


def ssd_mixer_plain(p: dict, cfg, proj: torch.Tensor, cache: dict | None,
                    valid: torch.Tensor | None) -> torch.Tensor:
    """The chunked mixer in PyTorch operations: the conv as a sum of
    shifted slices at the compute type, the SSD (:func:`_ssd_chunked`) on
    float32 copies of x, B, C and dt, then :func:`gated_norm`."""
    b, s, _n = proj.shape
    cdt = proj.dtype
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    g = cfg.ssm_groups
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * g * ds, nh], -1)
    conv_w = p["conv_w"].to(cdt)
    conv_b = p["conv_b"].to(cdt)
    kw = cfg.ssm_conv
    rows = None if cache is None else cache.get("rows")
    padded = F.pad(xbc, (0, 0, kw - 1, 0))
    # the causal depthwise conv as a sum of shifted slices
    conv = sum(padded[:, i:i + s] * conv_w[i] for i in range(kw)) + conv_b
    new_conv = None
    if s >= kw - 1 and kw > 1:
        if valid is not None:
            # the window of the last kw-1 valid inputs
            start = valid.int().sum(1)                    # (B,)
            idx = start[:, None] + torch.arange(kw - 1, device=proj.device)
            new_conv = padded.gather(1, idx[..., None].expand(
                -1, -1, padded.shape[-1]))
        else:
            new_conv = padded[:, -(kw - 1):]
    conv = F.silu(conv)
    x, bm, cm = torch.split(conv, [di, g * ds, g * ds], -1)
    bm, cm = bm.reshape(b, s, g, ds), cm.reshape(b, s, g, ds)
    xh = x.reshape(b, s, nh, hd)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])       # (B,S,NH)
    if valid is not None:
        dtv = dtv * valid[:, :, None].float()
    y, new_state = _ssd_chunked(xh.float(), dtv, p["a_log"], bm.float(),
                                cm.float(), cfg.ssm_chunk)
    yn = gated_norm(p, y, xh, z, g, cfg.norm_eps)
    if cache is not None:
        write_rows(cache["state"], rows, new_state)
        if new_conv is not None:
            write_rows(cache["conv"], rows, new_conv)
    return yn


def ssd_step_plain(p: dict, cfg, proj: torch.Tensor, cache: dict,
                   valid: torch.Tensor | None) -> torch.Tensor:
    """The recurrent step in PyTorch operations: the conv over the cached
    window and the new input (an einsum at the compute type), the state
    update and ``y = C·state`` in float32, then :func:`gated_norm`; the new
    state and window copied into the cache."""
    b = proj.shape[0]
    cdt = proj.dtype
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    g = cfg.ssm_groups
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * g * ds, nh], -1)
    window = torch.cat([cache["conv"].to(cdt), xbc], 1)     # (B,kw,C)
    conv = (torch.einsum("bkc,kc->bc", window, p["conv_w"].to(cdt))
            + p["conv_b"].to(cdt))[:, None]
    conv = F.silu(conv)
    x, bm, cm = torch.split(conv, [di, g * ds, g * ds], -1)
    xh = x.reshape(b, 1, nh, hd)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])       # (B,1,NH)
    if valid is not None:
        dtv = dtv * valid[:, :, None].float()
    # each head's group of B and C: (B, NH, N)
    bh = bm[:, 0].float().reshape(b, g, ds).repeat_interleave(nh // g, 1)
    ch = cm[:, 0].float().reshape(b, g, ds).repeat_interleave(nh // g, 1)
    da = torch.exp(dtv[:, 0] * -torch.exp(p["a_log"]))   # (B,NH)
    upd = bh[..., None] \
        * (dtv[:, 0, :, None] * xh[:, 0].float())[:, :, None, :]
    new_state = cache["state"] * da[..., None, None] + upd
    y = (ch[:, :, None, :] @ new_state).reshape(b, 1, nh, hd)   # (B,1,NH,HD)
    yn = gated_norm(p, y, xh, z, g, cfg.norm_eps)
    cache["state"].copy_(new_state)
    cache["conv"].copy_(window[:, 1:])
    return yn


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------
_VP, _INT = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    """``csrc/ssd.cu``, built on first use."""
    global _LIB
    if _LIB is None:
        from . import build
        lib = build.load("ssd")
        lib.ssd_mixer.argtypes = [_VP] * 16 + [_INT] * 6 + [
            ctypes.c_float, _INT, _INT, _VP]
        lib.ssd_mixer.restype = ctypes.c_int
        lib.ssd_step.argtypes = [_VP] * 14 + [_INT] * 4 + [
            ctypes.c_float, _INT, _INT, _VP]
        lib.ssd_step.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_call(cfg, proj: torch.Tensor, cache: dict | None,
                valid: torch.Tensor | None) -> None:
    """What both paths take: the compute type, the widths, the valid mask
    and the caches (of the call's rows, or a larger cache's under
    ``"rows"``)."""
    b, s, width = proj.shape
    nh, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    if proj.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernels take bf16 or float32, not "
                         f"{proj.dtype}")
    if (cfg.ssm_head_dim != HEAD_DIM or n not in STATES
            or cfg.ssm_conv != CONV or nh % g
            or cfg.d_inner != nh * HEAD_DIM
            or cfg.d_inner // g > GROUP_WIDTH):
        raise ValueError(
            f"the kernels take head dim {HEAD_DIM}, state {STATES}, conv "
            f"{CONV} and whole groups of heads at most {GROUP_WIDTH} wide; "
            f"got head dim {cfg.ssm_head_dim}, state {n}, conv "
            f"{cfg.ssm_conv}, {nh} heads in {g} groups")
    if width != 2 * cfg.d_inner + 2 * g * n + nh:
        raise ValueError(f"projection width {width} does not fit the config")
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != (b, s)):
        raise ValueError(f"want a bool valid mask ({b}, {s}), got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if cache is not None:
        st, cv = cache["state"], cache["conv"]
        rows = cache.get("rows")
        n_rows = st.shape[0] if rows is not None else b
        if (st.dtype != torch.float32 or cv.dtype != proj.dtype
                or tuple(st.shape) != (n_rows, nh, n, HEAD_DIM)
                or tuple(cv.shape) != (n_rows, CONV - 1,
                                       cfg.d_inner + 2 * g * n)
                or not st.is_contiguous() or not cv.is_contiguous()):
            raise ValueError(
                f"want contiguous caches, state ({n_rows}, {nh}, {n}, "
                f"{HEAD_DIM}) float32 and conv ({n_rows}, {CONV - 1}, ...) "
                f"{proj.dtype}; got {st.dtype} {tuple(st.shape)}, "
                f"{cv.dtype} {tuple(cv.shape)}")
        if rows is not None and (rows.dtype != torch.int64
                                 or tuple(rows.shape) != (b,)):
            raise ValueError(f"want int64 rows ({b},), got {rows.dtype} "
                             f"{tuple(rows.shape)}")


def _check(cfg, proj: torch.Tensor, cache: dict | None,
           valid: torch.Tensor | None) -> None:
    """The chunked path's shapes: :func:`_check_call` and the chunk."""
    _check_call(cfg, proj, cache, valid)
    s = proj.shape[1]
    if cfg.ssm_chunk not in CHUNKS:
        raise ValueError(f"the kernels take chunk {CHUNKS}, not "
                         f"{cfg.ssm_chunk}")
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"seq {s} must be divisible by chunk {q}")


def _check_step(cfg, proj: torch.Tensor, cache: dict,
                valid: torch.Tensor | None) -> None:
    """The step's shapes: one token a row and a cache of the call's rows
    (no ``"rows"``); the chunk plays no part."""
    if proj.dim() != 3 or proj.shape[1] != 1 or cache is None \
            or "rows" in cache:
        raise ValueError("the step takes (B, 1, ...) with a cache of B rows "
                         "and no \"rows\"")
    _check_call(cfg, proj, cache, valid)


def _operands(p: dict, cdt: torch.dtype) -> tuple:
    """The mixer's small parameters as the kernels read them: the conv's
    at the compute type, the decay, dt bias and skip in float32, the norm's
    scale in bf16 or float32; contiguous (no copy where they are so)."""
    scale = p["norm"]["scale"]
    if scale.dtype != torch.bfloat16:
        scale = scale.float()
    return (p["conv_w"].to(cdt).contiguous(), p["conv_b"].to(cdt).contiguous(),
            *(p[k].float().contiguous()
              for k in ("a_log", "dt_bias", "d_skip")), scale.contiguous())


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream_of(dev: torch.device):
    return _stream(torch.cuda.current_device() if dev.index is None
                   else dev.index)


def ssd_mixer_cuda(p: dict, cfg, proj: torch.Tensor, cache: dict | None,
                   valid: torch.Tensor | None) -> torch.Tensor:
    """The five launches on the current stream; raises on what they do not
    take.  Allocates the output and the scratch."""
    _check(cfg, proj, cache, valid)
    b, s, _w = proj.shape
    nh, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    cdt, dev = proj.dtype, proj.device
    q = min(cfg.ssm_chunk, s)
    proj = proj.contiguous()
    conv_w, conv_b, a_log, dt_bias, d_skip, scale = _operands(p, cdt)
    xbc = torch.empty((b, s, cfg.d_inner + 2 * g * n), dtype=cdt, device=dev)
    dtv = torch.empty((2, b, nh, s), dtype=torch.float32, device=dev)
    states = torch.empty((b, s // q, nh, n, HEAD_DIM), dtype=torch.float32,
                         device=dev)
    out = torch.empty((b, s, cfg.d_inner), dtype=cdt, device=dev)
    if valid is not None:
        valid = valid.contiguous()
    rows = state = conv = None
    if cache is not None:
        rows, state = cache.get("rows"), cache["state"]
        if s >= CONV - 1:
            conv = cache["conv"]
    err = _lib().ssd_mixer(
        _ptr(proj), _ptr(conv_w), _ptr(conv_b), _ptr(a_log), _ptr(dt_bias),
        _ptr(d_skip), _ptr(scale), _ptr(valid), _ptr(rows), _ptr(state),
        _ptr(conv), _ptr(xbc), _ptr(dtv[0]), _ptr(dtv[1]), _ptr(states),
        _ptr(out), b, s, nh, g, n, q, cfg.norm_eps,
        int(cdt == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        _stream_of(dev))
    if err:
        raise RuntimeError(f"ssd_mixer launch failed: CUDA error {err}")
    launches["ssd"] += KERNELS
    return out


def ssd_step_cuda(p: dict, cfg, proj: torch.Tensor, cache: dict,
                  valid: torch.Tensor | None) -> torch.Tensor:
    """The step's three launches on the current stream, the cache's state
    and conv window written in place; raises on what they do not take.
    Allocates the output and the scratch (the activated ``[x, B, C]``, dt
    and its decay): nothing the size of the state."""
    _check_step(cfg, proj, cache, valid)
    b = proj.shape[0]
    nh, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    cdt, dev = proj.dtype, proj.device
    proj = proj.contiguous()
    conv_w, conv_b, a_log, dt_bias, d_skip, scale = _operands(p, cdt)
    xbc = torch.empty((b, cfg.d_inner + 2 * g * n), dtype=cdt, device=dev)
    dtv = torch.empty((2, b, nh), dtype=torch.float32, device=dev)
    out = torch.empty((b, 1, cfg.d_inner), dtype=cdt, device=dev)
    if valid is not None:
        valid = valid.contiguous()
    err = _lib().ssd_step(
        _ptr(proj), _ptr(conv_w), _ptr(conv_b), _ptr(a_log), _ptr(dt_bias),
        _ptr(d_skip), _ptr(scale), _ptr(valid), _ptr(cache["state"]),
        _ptr(cache["conv"]), _ptr(xbc), _ptr(dtv[0]), _ptr(dtv[1]),
        _ptr(out), b, nh, g, n, cfg.norm_eps, int(cdt == torch.bfloat16),
        int(scale.dtype == torch.bfloat16), _stream_of(dev))
    if err:
        raise RuntimeError(f"ssd_step launch failed: CUDA error {err}")
    launches["ssd_step"] += STEP_KERNELS
    return out
