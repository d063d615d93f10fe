"""Mamba2 (SSD, state-space duality) blocks of the port
(``repro.models.ssm``): the chunked scan for prefill and training, the
recurrent step for decode.

Input projection to (z, x, B, C, dt), a causal depthwise conv on (x, B, C),
one scalar decay ``A = -exp(a_log)`` per head, the SSD over chunks (the
quadratic dual form within a chunk, the state recurrence between chunks),
a gated RMSNorm and the output projection.  Shapes: ``d_inner = expand ·
d_model`` (or ``ssm_n_heads · ssm_head_dim``), ``nh = d_inner /
ssm_head_dim`` heads, state ``N = ssm_state``, ``G = ssm_groups`` groups of
B and C (each ``N`` wide; head ``h`` reads group ``h // (nh / G)``), and
the gated RMSNorm taken over each of ``G`` equal slices of ``d_inner``
(Mamba-2's grouped norm; one slice for ``G = 1``).

While a profile records (:mod:`repro_torch.trace`), the chunked SSD of an
eager call runs inside an ``ssm.scan`` span; a CUDA graph replay opens
none.

The reference's float32 sections are kept: the SSD and the recurrent step
run in float32 on float32 copies of x, B, C and dt; the conv, the gate and
the projections at the compute type.  Its 3- and 4-operand einsums are
written as pairwise products that build no ``(…, Q, N, HD)`` intermediate,
and its ``lax.scan`` over chunks is a loop that emits the previous state.
With a cache, the new state and conv window are written into the cache in
place, as the port's KV caches are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from .. import trace
from .config import ModelConfig
from .layers import (_dt, batch_placements, dense_init, local_call,
                     row_partial)

A_INIT_RANGE = (1.0, 16.0)


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The reference's distributions: dense N(0, 1/in), conv N(0, 1/kw),
    ``a_log = log(linspace(1, 16, nh))``, ``dt_bias`` the inverse softplus
    of a log-uniform draw in [1e-3, 1e-1], ``d_skip`` ones."""
    dt = _dt(cfg, "param")
    dev = gen.device
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gs = cfg.ssm_groups * cfg.ssm_state
    conv_dim = di + 2 * gs
    lo, hi = math.log(1e-3), math.log(1e-1)
    p = {
        # fused input projection: z, x, B, C, dt
        "w_in": dense_init(gen, d, 2 * di + 2 * gs + nh, dt),
        "conv_w": (torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                               device=dev)
                   / math.sqrt(cfg.ssm_conv)).to(dt),
        # a pattern model draws its conv bias N(0, 1/kw), so that the
        # bias is exercised (the published checkpoints carry one)
        "conv_b": (torch.randn((conv_dim,), generator=gen, device=dev)
                   / math.sqrt(cfg.ssm_conv)).to(dt) if cfg.layer_pattern
        else torch.zeros((conv_dim,), dtype=dt, device=dev),
        "a_log": torch.log(torch.linspace(*A_INIT_RANGE, nh, device=dev)),
        "dt_bias": torch.log(torch.expm1(torch.exp(
            torch.rand((nh,), generator=gen, device=dev) * (hi - lo) + lo))),
        "d_skip": torch.ones((nh,), device=dev),
        "norm": {"scale": torch.ones((di,), dtype=dt, device=dev)},
        "w_out": dense_init(gen, di, d, dt),
    }
    return p


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


def apply_ssm(p: dict, cfg: ModelConfig, u: torch.Tensor, *,
              ssm_cache: dict | None = None,
              valid: torch.Tensor | None = None,
              ) -> tuple[torch.Tensor, dict | None]:
    """u: (B, S, D) -> (out, cache).

    Prefill and training run the chunked SSD; decode (``ssm_cache`` given,
    S == 1, no ``"rows"``) the O(1) recurrent step.  ``valid``: an
    optional (B, S) mask of a right-padded prefill — padded steps neither
    decay nor write the state (dt forced to 0) and the conv window kept is
    the last ``kw − 1`` valid inputs.  The cache, ``{"state": (B, NH, N,
    HD) float32, "conv": (B, kw − 1, conv_dim)}``, is **updated in place**
    and returned (a prefill shorter than ``kw − 1`` keeps the old conv
    window, as the reference); with ``"rows"`` (B,) in it, a prefill
    writes those batch rows of a larger cache."""
    cdt = _dt(cfg, "compute")
    proj = u @ p["w_in"].to(cdt)                          # (B,S,2di+2ds+nh)
    if isinstance(proj, DTensor) and ssm_cache is None:
        yn = _mixer_sharded(p, cfg, proj, valid)
    else:
        yn = _mixer(p, cfg, proj, ssm_cache, valid)
    return yn @ p["w_out"].to(cdt), ssm_cache


#: the mixer's parameters besides the projections
_MIXER_KEYS = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip")


def _mixer_sharded(p: dict, cfg: ModelConfig, proj: DTensor, valid):
    """:func:`_mixer` on a mesh, without a cache (training, a prefill):
    on each rank's batch rows, the projection's columns and the mixer's
    small parameters gathered (their gradients a ``Partial`` sum over the
    ranks that split the rows).  Run as DTensor ops, the SSD's 5-axis
    intermediates made DTensor's redistribution planner the step's largest
    cost (16 of 25 s for mamba2's smoke config on a fake (4, 2) mesh), and
    a view of the split projection failed DTensor's propagation in torch
    2.11; the chunk recurrence is per sequence, so each rank's rows are
    independent."""
    mesh = proj.device_mesh
    rows = batch_placements(mesh, proj.shape[0])
    full = [Replicate()] * mesh.ndim
    leaves = [p[k] for k in _MIXER_KEYS] + [p["norm"]["scale"]]

    def region(proj, valid, *leaves):
        q = dict(zip(_MIXER_KEYS, leaves[:-1], strict=True))
        q["norm"] = {"scale": leaves[-1]}
        return _mixer(q, cfg, proj, None, valid)

    return local_call(region, (proj, valid, *leaves),
                      (rows, None if valid is None else rows,
                       *[full] * len(leaves)), rows,
                      grad_placements=(None, None, *[row_partial(rows)]
                                       * len(leaves)))


def _mixer(p: dict, cfg: ModelConfig, proj: torch.Tensor,
           ssm_cache: dict | None, valid: torch.Tensor | None
           ) -> torch.Tensor:
    """The block between its projections: (B, S, 2di + 2ds + nh) -> the
    gated-normed (B, S, di); the cache, if any, written in place."""
    b, s, _n = proj.shape
    cdt = _dt(cfg, "compute")
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    g = cfg.ssm_groups
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * g * ds, nh], -1)

    conv_w = p["conv_w"].to(cdt)
    conv_b = p["conv_b"].to(cdt)
    kw = cfg.ssm_conv
    rows = None if ssm_cache is None else ssm_cache.get("rows")
    chunked = ssm_cache is None or s > 1 or rows is not None
    if chunked:
        padded = F.pad(xbc, (0, 0, kw - 1, 0))
        # the causal depthwise conv as a sum of shifted slices
        conv = sum(padded[:, i:i + s] * conv_w[i] for i in range(kw)) \
            + conv_b
        new_conv = None
        if s >= kw - 1 and kw > 1:
            if valid is not None:
                # the window of the last kw-1 valid inputs
                start = valid.int().sum(1)                # (B,)
                idx = start[:, None] + torch.arange(kw - 1,
                                                    device=proj.device)
                new_conv = padded.gather(1, idx[..., None].expand(
                    -1, -1, padded.shape[-1]))
            else:
                new_conv = padded[:, -(kw - 1):]
    else:
        window = torch.cat([ssm_cache["conv"].to(cdt), xbc], 1)  # (B,kw,C)
        conv = (torch.einsum("bkc,kc->bc", window, conv_w) + conv_b)[:, None]
        new_conv = window[:, 1:]
    conv = F.silu(conv)
    x, bm, cm = torch.split(conv, [di, g * ds, g * ds], -1)
    bm, cm = bm.reshape(b, s, g, ds), cm.reshape(b, s, g, ds)
    xh = x.reshape(b, s, nh, hd)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])       # (B,S,NH)
    if valid is not None:
        dtv = dtv * valid[:, :, None].float()

    if chunked:
        with trace.span("ssm.scan"):
            y, new_state = _ssd_chunked(xh.float(), dtv, p["a_log"],
                                        bm.float(), cm.float(), cfg.ssm_chunk)
    else:
        # each head's group of B and C: (B, NH, N)
        bh = bm[:, 0].float().repeat_interleave(nh // g, 1)
        ch = cm[:, 0].float().repeat_interleave(nh // g, 1)
        da = torch.exp(dtv[:, 0] * -torch.exp(p["a_log"]))   # (B,NH)
        upd = bh[..., None] \
            * (dtv[:, 0, :, None] * xh[:, 0].float())[:, :, None, :]
        new_state = ssm_cache["state"] * da[..., None, None] + upd
        y = (ch[:, :, None, :] @ new_state)               # (B,NH,1,HD)
        y = y.reshape(b, 1, nh, hd)
    y = y + p["d_skip"][:, None] * xh.float()
    y = y.reshape(b, s, di).to(cdt)
    # the gated RMSNorm (mamba2's norm before the output projection), over
    # each of the G slices of d_inner
    yz = (y * F.silu(z)).float().reshape(b, s, g, di // g)
    var = yz.square().mean(-1, keepdim=True)
    yn = (yz * torch.rsqrt(var + cfg.norm_eps)).reshape(b, s, di)
    yn = (yn * p["norm"]["scale"].float()).to(cdt)
    if ssm_cache is not None:
        _write(ssm_cache["state"], rows, new_state)
        if new_conv is not None:
            _write(ssm_cache["conv"], rows, new_conv)
    return yn


def _write(cache: torch.Tensor, rows: torch.Tensor | None,
           new: torch.Tensor) -> None:
    """``new`` into the cache in place: every row, or the batch rows
    ``rows`` of a larger cache."""
    if rows is None:
        cache.copy_(new)
    else:
        cache.index_copy_(0, rows, new.to(cache.dtype))


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """A zero state (float32) and conv window (the compute type)."""
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             cfg.d_inner + 2 * cfg.ssm_groups
                             * cfg.ssm_state),
                            dtype=_dt(cfg, "compute"), device=device),
    }
