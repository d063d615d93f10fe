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
:func:`fused_attention` too.  The mesh constraints (``constrain_*``) are
no-ops without a mesh and are left out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
    (the reference's ``layers.fused_attention``, with K/V unrepeated)."""
    return FusedAttention.apply(q, k, v, q_pos, kv_pos, window, softcap)


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel reads position
    rows: a slice such as ``pos[:, t:t + 1]`` is contiguous but may start
    anywhere, so it is copied."""
    t = t.contiguous()
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
    xq = (x @ p["wq"].to(cdt)).reshape(b, s, cfg.n_heads, hd)
    xk = (x @ p["wk"].to(cdt)).reshape(b, s, cfg.n_kv_heads, hd)
    xv = (x @ p["wv"].to(cdt)).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        xq = rmsnorm(p["q_norm"], xq, cfg.norm_eps)
        xk = rmsnorm(p["k_norm"], xk, cfg.norm_eps)
    xq = apply_rope(xq, positions, cfg.rope_theta)
    xk = apply_rope(xk, positions, cfg.rope_theta)
    positions = _aligned(positions.to(torch.int32))

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
    xq = (x @ p["wq"].to(cdt)).reshape(b, s, cfg.n_heads, hd)
    xk = (img @ p["wk"].to(cdt)).reshape(b, t, cfg.n_kv_heads, hd)
    xv = (img @ p["wv"].to(cdt)).reshape(b, t, cfg.n_kv_heads, hd)
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
    """Rows of the table at the compute type (gathered, then cast)."""
    return p["table"][tokens].to(_dt(cfg, "compute"))


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """-> logits (..., V) in float32: the table cast to x's type, then a
    float32 product (exact products of bf16 operands, float32 sums — the
    reference's preferred_element_type=float32)."""
    return x.float() @ p["table"].to(x.dtype).float().T
