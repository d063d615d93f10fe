"""Decoder layers of the port (``repro.models.layers``): RMSNorm, RoPE, GQA
attention with a KV cache, cross-attention, SwiGLU, embedding.

Plain-function style as in the reference: ``init_*`` build parameter dicts
of tensors (dense weights ``(in, out)``, applied as ``x @ w``), ``apply_*``
run them.  The reference's cast points are kept, because they decide
bf16 parity: weights cast to the compute type at use, RMSNorm's variance
in float32 with ``inv`` cast to the activation type (and its backward the
reference's ``custom_vjp``, :class:`RMSNorm`), RoPE's cos / sin in float32
cast to ``x``'s type, logits in float32.

Every attention — prefill, prefill into a cache, decode — is one call of
:func:`repro_torch.kernels.ops.flash_attention` on the unrepeated K/V: the
hand-written kernel on a CUDA tensor, its plain twin on a CPU one.
Without a cache it goes through :func:`fused_attention`, the autograd
function of the reference's ``fused_attention`` region: its backward is
:func:`repro_torch.kernels.ops.flash_attention_bwd` (the backward kernel
on the card), from the ``out`` and ``lse`` the forward saved.  The
reference chooses between its region and an unfused jnp path by
``cfg.fused_attention``; both compute the same function, and
``cfg.fused_attention`` has no effect here.  A call with ``extra_mask``
takes the reference's unfused path, as its ``_flash_attend`` routes it:
the kernel's plain twin with the mask, torch ops on any device.
Cross-attention (:func:`apply_cross_attention`) goes through
:func:`fused_attention` too.

**Under a mesh** (DTensor parameters and batch, ``launch/sharding.py``)
every op runs through DTensor's sharding propagation, except the regions
that have no sharding rule or call a kernel, which run on each rank's
local tensors (:func:`local_call`): the attention region on its batch rows
and its local heads (:func:`fused_attention`; the heads are split on the
``model`` axis only where both the query and the kv heads divide it, else
the projections' column split is gathered first — qwen3-4b's ``wk`` puts
40 columns, half a head, on each of 16 ranks), the cached attention
(:func:`apply_attention`: each rank writes and attends over its slice of
the sequence-sharded cache, the partial outputs merged by their ``lse``),
the loss head (``transformer.py``), the SSM mixer (``ssm.py``) and the
MoE dispatch (``moe.py``).  The reference's mesh constraints
(``constrain_*``) are hints to GSPMD and have no counterpart.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import ops
from ..kernels.flash_attention import flash_attention_plain
from .config import ModelConfig

#: position sentinel of unwritten cache slots — never passes the causal
#: check (q_pos >= kv_pos), so stale slots are invisible
POS_SENTINEL = (2 ** 31 - 1) // 2


def _dt(cfg: ModelConfig, kind: str) -> torch.dtype:
    s = cfg.param_dtype if kind == "param" else cfg.compute_dtype
    return getattr(torch, s)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/in) weights of shape (in, out), drawn in float32."""
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


# ---------------------------------------------------------------------------
# Regions run on each rank's local tensors under a mesh
# ---------------------------------------------------------------------------
def batch_axes(mesh, b: int) -> tuple[str, ...]:
    """The data-parallel axes (all but ``model``) that a global batch of
    ``b`` rows shards over: as many as divide it, in order (the rule of
    ``launch.sharding.batch_axis_spec``)."""
    use, rem = [], b
    for name, size in zip(mesh.mesh_dim_names, mesh.shape, strict=True):
        if name != "model" and rem % size == 0 and rem >= size:
            use.append(name)
            rem //= size
    return tuple(use)


def batch_placements(mesh, b: int) -> list:
    """Placements of each rank's rows of a ``b``-row batch axis (dim 0):
    ``Shard(0)`` on its :func:`batch_axes` of more than one rank,
    everything else gathered (as ``launch.sharding.to_placements``)."""
    axes = batch_axes(mesh, b)
    return [Shard(0) if name in axes and size > 1 else Replicate()
            for name, size in zip(mesh.mesh_dim_names, mesh.shape,
                                  strict=True)]


def to_local_as(t, mesh, placements, grad_placements=None) -> torch.Tensor:
    """``t`` placed by ``placements`` on ``mesh`` -> this rank's local
    tensor, differentiably (a plain tensor is taken as replicated: each
    rank holds all of it).  ``grad_placements``: how the local gradient
    is placed, when it is not placed as the forward is (see
    :func:`row_partial`)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)


def row_partial(rows: list) -> list:
    """The gradient placements of a tensor gathered whole on every rank
    and used by a computation on each rank's rows (``rows``): on each
    axis that splits the rows, every rank holds only its rows' share of
    the gradient — a ``Partial`` sum."""
    return [Partial() if isinstance(p, Shard) else Replicate()
            for p in rows]


def local_call(fn, args, placements, out_placements, grad_placements=None):
    """``fn`` on local tensors: each argument placed by its entry of
    ``placements`` (``None``: passed as it is), its gradient by its entry
    of ``grad_placements`` (default: as the forward), the outputs (a
    tensor or a tuple) wrapped back as DTensors by ``out_placements``."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    grads = grad_placements or [None] * len(args)
    local = [a if pl is None else to_local_as(a, mesh, pl, g)
             for a, pl, g in zip(args, placements, grads, strict=True)]
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o, pl in zip(out, out_placements, strict=True))
    return DTensor.from_local(out, mesh, out_placements, run_check=False)


def _model_axis(mesh) -> tuple[int | None, int]:
    """(index, size) of the mesh's ``model`` axis; (None, 1) without."""
    names = mesh.mesh_dim_names
    if "model" not in names:
        return None, 1
    i = names.index("model")
    return i, mesh.shape[i]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


class RMSNorm(torch.autograd.Function):
    """The reference's ``_rmsnorm_cv`` ``custom_vjp``: the forward reduces
    the variance in float32 and casts ``inv`` to x's type; the backward
    (``_rmsnorm_bwd``) works in x's type with the reference's rounding
    points — ``dy`` cast to x's type, ``dy_s = dy·s``, the row mean of
    ``dy_s·x`` summed in float32, ``coef = inv³·m`` rounded to x's type,
    ``dx = dy_s·inv − x·coef`` — and sums ``dscale = Σ dy·x·inv`` in
    float32 over every leading axis, cast to the scale's type."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        var = x.float().square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        ctx.save_for_backward(x, inv, scale)
        return x * inv * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, inv, scale = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dy_s = dy * scale.to(x.dtype)
        m = (dy_s * x).float().sum(-1, keepdim=True) / x.shape[-1]
        inv32 = inv.float()
        coef = (inv32 * inv32 * inv32 * m).to(x.dtype)
        dx = dy_s * inv - x * coef
        dscale = (dy * x * inv).float().sum(dim=tuple(range(x.dim() - 1)))
        return dx, dscale.to(scale.dtype), None


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with the variance reduced in float32 and the reference's
    backward (:class:`RMSNorm`)."""
    return RMSNorm.apply(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int32.  cos / sin in float32,
    cast to x's type; the rotation at x's type."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang).to(x.dtype)[:, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


# ---------------------------------------------------------------------------
# The fused attention region: forward and backward kernels
# ---------------------------------------------------------------------------
class FusedAttention(torch.autograd.Function):
    """The reference's ``fused_attention`` ``custom_vjp`` (``_fa_fwd`` /
    ``_fa_bwd``): the forward saves ``out`` and ``lse`` beside its inputs,
    the backward recomputes the scores from them.  q (B, Sq, H, hd), k / v
    (B, Sk, KV, hd) unrepeated; dk / dv come back per kv head.  The
    positions get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, window: int, softcap: float):
        out, lse = ops.flash_attention(q, k, v, q_pos, kv_pos, window=window,
                                       softcap=softcap)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.window, ctx.softcap = window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(
            q, k, v, q_pos, kv_pos, out, lse, dout.contiguous(),
            window=ctx.window, softcap=ctx.softcap)
        return dq, dk, dv, None, None, None, None


def fused_attention(window: int, softcap: float, q, k, v, q_pos, kv_pos):
    """Attention through the region's kernels, differentiable in q, k, v
    (the reference's ``layers.fused_attention``, with K/V unrepeated).
    DTensor inputs: the kernels run on each rank's batch rows and, where
    the query and kv heads both divide the ``model`` axis, its heads."""
    if not isinstance(q, DTensor):
        return FusedAttention.apply(q, k, v, q_pos, kv_pos, window, softcap)
    rows = batch_placements(q.device_mesh, q.shape[0])
    heads = list(rows)
    i, m = _model_axis(q.device_mesh)
    if m > 1 and q.shape[2] % m == 0 and k.shape[2] % m == 0:
        heads[i] = Shard(2)

    def region(q, k, v, q_pos, kv_pos):
        return FusedAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), _aligned(q_pos),
                                    _aligned(kv_pos), window, softcap)

    return local_call(region, (q, k, v, q_pos, kv_pos),
                      (heads, heads, heads, rows, rows), heads)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = _dt(cfg, "param")
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dt),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dt, gen.device)
        p["k_norm"] = init_rmsnorm(hd, dt, gen.device)
    return p


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n·hd) -> (B, S, n, hd).  On a mesh, where a projection's
    column split does not fall on head boundaries (``n`` does not divide
    that mesh axis: qwen3-4b's ``wk``, 8 heads of 80 over 16 ranks, puts 40
    columns — half a head — on each), those columns are gathered first."""
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        pl = [Replicate() if isinstance(p, Shard) and p.dim == t.ndim - 1
              and n % mesh.shape[j] else p
              for j, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(*t.shape[:-1], n, hd)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel reads position
    rows: a slice such as ``pos[:, t:t + 1]`` is contiguous but may start
    anywhere, so it is copied."""
    t = t.contiguous()
    if is_fake(t):      # shapes only (the dry-run): no address to align
        return t
    return t.clone() if t.data_ptr() % 16 else t


def apply_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    kv_cache: dict | None = None,
                    extra_mask: torch.Tensor | None = None,
                    ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D); positions (B, S) int32.  Without a cache (training,
    a plain forward) the attention is :func:`fused_attention`, or with
    ``extra_mask`` (B, S, S) the unfused path, the plain twin with the
    mask (the reference's routing).  kv_cache: {"k", "v": (B, S_max, KV,
    hd), "pos": (B, S_max) int32}, **updated in place** and returned;
    positions sliced from a longer row are copied to aligned rows for the
    kernel (:func:`_aligned`).  Decode (S == 1)
    writes the ring buffer at ``position % S_max``, a prefill into the
    cache (S > 1) writes its block at 0; the reference's cached path takes
    no ``extra_mask``."""
    b, s, _d = x.shape
    hd = cfg.hd
    cdt = _dt(cfg, "compute")
    xq = _split_heads(x @ p["wq"].to(cdt), cfg.n_heads, hd)
    xk = _split_heads(x @ p["wk"].to(cdt), cfg.n_kv_heads, hd)
    xv = _split_heads(x @ p["wv"].to(cdt), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        xq = rmsnorm(p["q_norm"], xq, cfg.norm_eps)
        xk = rmsnorm(p["k_norm"], xk, cfg.norm_eps)
    xq = apply_rope(xq, positions, cfg.rope_theta)
    xk = apply_rope(xk, positions, cfg.rope_theta)
    positions = positions.to(torch.int32)
    if not isinstance(positions, DTensor):
        positions = _aligned(positions)

    if kv_cache is None:
        if extra_mask is None:
            out = fused_attention(cfg.sliding_window, cfg.attn_logit_softcap,
                                  xq, xk, xv, positions, positions)
        else:
            out, _lse = flash_attention_plain(
                xq, xk, xv, positions, positions, window=cfg.sliding_window,
                softcap=cfg.attn_logit_softcap, extra_mask=extra_mask)
        out = out.reshape(b, s, cfg.n_heads * hd)
        return out @ p["wo"].to(cdt), None
    if isinstance(kv_cache["k"], DTensor):
        out = _cached_attention_sharded(cfg, xq, xk, xv, positions, kv_cache)
        out = out.reshape(b, s, cfg.n_heads * hd)
        return out @ p["wo"].to(cdt), kv_cache
    k, v, kv_pos = kv_cache["k"], kv_cache["v"], kv_cache["pos"]
    if s == 1:
        idx = positions[:, 0].long() % k.shape[1]
        bar = torch.arange(b, device=x.device)
        k[bar, idx] = xk[:, 0].to(k.dtype)
        v[bar, idx] = xv[:, 0].to(v.dtype)
        kv_pos[bar, idx] = positions[:, 0]
    else:
        k[:, :s] = xk
        v[:, :s] = xv
        kv_pos[:, :s] = positions
    out, _lse = ops.flash_attention(
        xq, k, v, positions, _aligned(kv_pos), window=cfg.sliding_window,
        softcap=cfg.attn_logit_softcap)
    out = out.reshape(b, s, cfg.n_heads * hd)
    return out @ p["wo"].to(cdt), kv_cache


def _cached_attention_sharded(cfg: ModelConfig, xq, xk, xv, positions,
                              kv_cache: dict):
    """The cached attention on a mesh, the cache (B, S_max, KV, hd) placed
    by ``cache_specs`` (batch on the dp axes, the sequence on ``model``):
    each rank writes the new keys that fall in its slice of the sequence
    into its shard in place (the ring slot ``position % S_max``, or a
    prefill's block at 0), attends over its slice with the kernel, and the
    ranks of the ``model`` axis merge their partial outputs by their
    ``lse`` (flash-decode: an all-gather of the lse, an all-reduce of the
    weighted outputs).  -> out (B, S, H, hd), batch-sharded as ``xq``."""
    kc, vc, pc = kv_cache["k"], kv_cache["v"], kv_cache["pos"]
    mesh = kc.device_mesh
    rows = batch_placements(mesh, kc.shape[0])
    i, m = _model_axis(mesh)
    split = (i is not None and m > 1 and isinstance(kc.placements[i], Shard)
             and kc.placements[i].dim == 1)
    s_all = kc.shape[1]
    k, v, kv_pos = kc.to_local(), vc.to_local(), pc.to_local()
    s_loc = k.shape[1]
    off = mesh.get_local_rank("model") * s_loc if split else 0
    q, nk, nv, pos = (to_local_as(t, mesh, rows)
                      for t in (xq, xk, xv, positions))
    b, s = q.shape[:2]
    if s == 1:
        idx = pos[:, 0].long() % s_all - off
        mine = (idx >= 0) & (idx < s_loc)
        idx = idx.clamp(0, s_loc - 1)
        bar = torch.arange(b, device=q.device)
        for cache, new in ((k, nk[:, 0]), (v, nv[:, 0]),
                           (kv_pos, pos[:, 0])):
            keep = mine.reshape(-1, *[1] * (new.dim() - 1))
            cache[bar, idx] = torch.where(keep, new.to(cache.dtype),
                                          cache[bar, idx])
    else:
        n = min(max(s - off, 0), s_loc)
        k[:, :n] = nk[:, off:off + n]
        v[:, :n] = nv[:, off:off + n]
        kv_pos[:, :n] = pos[:, off:off + n]
    out, lse = ops.flash_attention(q, k, v, _aligned(pos), _aligned(kv_pos),
                                   window=cfg.sliding_window,
                                   softcap=cfg.attn_logit_softcap)
    if split:
        # (B, H, S) lse of every slice -> each slice's weight
        stack = [Shard(1) if isinstance(pl, Shard) else Replicate()
                 for pl in rows]
        gathered = list(stack)
        stack[i] = Shard(0)
        lse_all = DTensor.from_local(lse[None], mesh, stack, run_check=False
                                     ).redistribute(mesh, gathered).to_local()
        w = torch.exp(lse - torch.logsumexp(lse_all, 0))
        part = list(rows)
        part[i] = Partial()
        out = DTensor.from_local(
            out.float() * w.permute(0, 2, 1)[..., None], mesh, part,
            run_check=False).redistribute(mesh, rows).to_local().to(q.dtype)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def init_kv_cache(cfg: ModelConfig, batch: int, s_max: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    return {
        "k": torch.zeros((batch, s_max, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, s_max, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, s_max), POS_SENTINEL, dtype=torch.int32,
                          device=device),
    }


# ---------------------------------------------------------------------------
# Cross-attention (VLM): queries from the text, K/V from the image
# ---------------------------------------------------------------------------
def init_cross_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return init_attention(gen, cfg)


def apply_cross_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                          image_embeds: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); image_embeds: (B, T_img, D) (the stub frontend's
    output).  Non-causal: every text token sees every image token (query
    positions 1, image positions 0), no RoPE, no window, no softcap;
    through :func:`fused_attention`."""
    b, s, _d = x.shape
    t = image_embeds.shape[1]
    hd = cfg.hd
    cdt = _dt(cfg, "compute")
    img = image_embeds.to(cdt)
    xq = _split_heads(x @ p["wq"].to(cdt), cfg.n_heads, hd)
    xk = _split_heads(img @ p["wk"].to(cdt), cfg.n_kv_heads, hd)
    xv = _split_heads(img @ p["wv"].to(cdt), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        xq = rmsnorm(p["q_norm"], xq, cfg.norm_eps)
        xk = rmsnorm(p["k_norm"], xk, cfg.norm_eps)
    q_pos = torch.ones((b, s), dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    out = fused_attention(0, 0.0, xq, xk, xv, q_pos, kv_pos)
    return out.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(cdt)


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> dict:
    dt = _dt(cfg, "param")
    d_ff = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, cfg.d_model, d_ff, dt),
        "w_up": dense_init(gen, cfg.d_model, d_ff, dt),
        "w_down": dense_init(gen, d_ff, cfg.d_model, dt),
    }


def apply_mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    cdt = _dt(cfg, "compute")
    g = F.silu(x @ p["w_gate"].to(cdt))
    u = x @ p["w_up"].to(cdt)
    return (g * u) @ p["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> dict:
    t = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                    device=gen.device) * 0.02
    return {"table": t.to(_dt(cfg, "param"))}


def embed(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table at the compute type (gathered, then cast).  On a
    mesh each rank gathers its rows from the whole table: DTensor's
    ``index_put`` rule (the gather's backward) fails in torch 2.11."""
    cdt = _dt(cfg, "compute")
    table = p["table"]
    if not isinstance(table, DTensor):
        return table[tokens].to(cdt)
    mesh = table.device_mesh
    rows = batch_placements(mesh, tokens.shape[0])
    full = [Replicate()] * mesh.ndim
    return local_call(lambda t, tok: t[tok].to(cdt), (table, tokens),
                      (full, rows), rows,
                      grad_placements=(row_partial(rows), None))


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """-> logits (..., V) in float32: the table cast to x's type, then a
    float32 product (exact products of bf16 operands, float32 sums — the
    reference's preferred_element_type=float32)."""
    return x.float() @ p["table"].to(x.dtype).float().T
