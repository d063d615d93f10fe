"""A plain float32 forward of IBM Granite 4.0-H Small (``granitemoehybrid``):
tokens to logits, one sequence, no cache, no batching, no kernel.

It imports nothing of the port and no JAX: plain ``torch`` operations on
the port's parameter tree (the weights under test), every weight cast to
float32 at use, with TF32 off for the products (set inside :func:`forward`
and restored after).  The configuration is a dict of the published
``config.json``'s keys (``layer_types``, ``hidden_size``,
``mamba_n_heads``, ``mamba_n_groups``, ``num_local_experts``,
``embedding_multiplier``, ...).

The layer equations (``x`` the residual stream, ``r`` the
``residual_multiplier``), as the published ``GraniteMoeHybrid`` modeling
computes them:

* ``x = embedding_multiplier · embed(tokens)``;
* every layer: ``x = x + r · mixer(rmsnorm₁(x))``, then ``x = x + r ·
  (moe(rmsnorm₂(x)) + shared(rmsnorm₂(x)))``; after the last layer a final
  ``rmsnorm`` and the tied unembedding (the embedding's table), divided
  by ``logits_scaling``; ``rms_norm_eps`` from the config;
* ``attention``: ``q, k, v = h·Wq, h·Wk, h·Wv`` (no bias), query head
  ``i`` reading kv head ``i // (H / KV)``, causal softmax of ``q·k ·
  attention_multiplier``, no positional embedding, then ``·Wo``;
* ``mamba``: ``h·W_in`` split into ``z, x, B, C, dt`` (widths ``d_inner,
  d_inner, G·N, G·N, heads``); a causal depthwise conv of width
  ``mamba_d_conv`` with bias over ``[x, B, C]`` (zeros before the first
  token), SiLU; ``dt = softplus(dt + dt_bias)`` (``time_step_limit`` (0,
  ∞): no clamp), ``A = −exp(A_log)``; the recurrence, one token after
  another, ``S_h ← exp(dt_h A_h) S_h + dt_h · B_g ⊗ x_h`` and ``y_h = C_g ·
  S_h + D_h x_h`` with ``g = h // (heads / G)``; ``y = rmsnorm(y ·
  silu(z)) · w`` over ``G`` slices of ``d_inner`` (one for Granite); then
  ``·W_out``;
* MoE: router logits ``h·Wr`` (no bias), the top ``k``, the softmax over
  those ``k``; each expert ``down(silu(g) · u)`` with ``[g, u]`` the two
  halves of ``h·W_in[e]ᵀ`` (``input_linear`` (E, 2F, D), gate rows first);
  the weighted sum, plus the shared expert's ``down(silu(g) · u)`` with
  ``[g, u] = h·W_shared`` (D, 2Fs).

Departures from the published model: random weights (the port's
``init_params``); the state recurrence written token by token (the
published kernels use the chunked scan, the same function); the router's
``k`` weights kept float32 (the published code casts them to the
activations' type before combining); everything in float32.

The parameter tree (the port's): ``embed.table`` (V, D),
``final_norm.scale``; ``blocks[i]`` ``{"norm": {"scale"}, mixer, "norm2":
{"scale"}, "moe"}`` with the mixer ``attn`` (``wq`` (D, H·hd), ``wk``,
``wv`` (D, KV·hd), ``wo`` (H·hd, D)) or ``ssm`` (``w_in`` (D, 2·di + 2·G·N
+ heads), ``conv_w`` (kw, C), ``conv_b`` (C,), ``a_log``, ``dt_bias``,
``d_skip`` (heads,), ``norm.scale`` (di,), ``w_out`` (di, D)), and ``moe``
(``router`` (D, E), ``w_gate_up`` (E, 2F, D), ``w_down`` (E, D, F),
``shared.w_gate_up`` (D, 2Fs), ``shared.w_down`` (Fs, D)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * _f(scale)


def attention(p: dict, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    s = h.shape[0]
    nh, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    q = (h @ _f(p["wq"])).reshape(s, nh, hd)
    k = (h @ _f(p["wk"])).reshape(s, kvh, hd)
    v = (h @ _f(p["wv"])).reshape(s, kvh, hd)
    rep = nh // kvh
    k = k.repeat_interleave(rep, 1)
    v = v.repeat_interleave(rep, 1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * cfg["attention_multiplier"]
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return out.reshape(s, nh * hd) @ _f(p["wo"])


def mamba(p: dict, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    s = h.shape[0]
    nh, hd = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    g, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    di = nh * hd
    kw = cfg["mamba_d_conv"]
    z, xbc, dt = torch.split(h @ _f(p["w_in"]), [di, di + 2 * g * n, nh], -1)
    # causal depthwise conv with bias, zeros before the first token
    pad = torch.cat([torch.zeros(kw - 1, xbc.shape[1], device=h.device),
                     xbc])
    w = _f(p["conv_w"])
    conv = torch.stack([(pad[t:t + kw] * w).sum(0) for t in range(s)]) \
        + _f(p["conv_b"])
    xbc = F.silu(conv)
    x, bm, cm = torch.split(xbc, [di, g * n, g * n], -1)
    x = x.reshape(s, nh, hd)
    bm, cm = bm.reshape(s, g, n), cm.reshape(s, g, n)
    dt = F.softplus(dt + _f(p["dt_bias"]))                 # (S, heads)
    a = -torch.exp(_f(p["a_log"]))
    group = torch.arange(nh, device=h.device) // (nh // g)
    state = torch.zeros(nh, n, hd, device=h.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[t] * a)                          # (heads,)
        bt, ct = bm[t, group], cm[t, group]                # (heads, N)
        state = state * da[:, None, None] \
            + dt[t][:, None, None] * bt[:, :, None] * x[t][:, None, :]
        ys.append(torch.einsum("hn,hnd->hd", ct, state)
                  + _f(p["d_skip"])[:, None] * x[t])
    y = torch.stack(ys).reshape(s, di) * F.silu(z)
    y = y.reshape(s, g, di // g)
    y = (y * torch.rsqrt(y.square().mean(-1, keepdim=True)
                         + cfg["rms_norm_eps"])).reshape(s, di) \
        * _f(p["norm"]["scale"])
    return y @ _f(p["w_out"])


def route(p: dict, cfg: dict, h: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (weights (S, k), experts (S, k)): the softmax over the top k
    router logits."""
    logits = h @ _f(p["router"])
    top, idx = torch.topk(logits, cfg["num_experts_per_tok"], -1)
    return torch.softmax(top, -1), idx


def swiglu(h: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor):
    """``down(silu(g) · u)``, ``[g, u] = h · gate_up`` (in, 2F), ``down``
    (F, out)."""
    g, u = (h @ _f(gate_up)).chunk(2, -1)
    return (F.silu(g) * u) @ _f(down)


def moe(p: dict, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    """The routed experts' weighted sum plus the shared expert."""
    w, idx = route(p, cfg, h)
    out = torch.zeros_like(h)
    for t in range(h.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            out[t] += w[t, j] * swiglu(h[t], p["w_gate_up"][e].T,
                                       p["w_down"][e].T)
    return out + swiglu(h, p["shared"]["w_gate_up"], p["shared"]["w_down"])


MIXERS = {"attention": ("attn", attention), "mamba": ("ssm", mamba)}


def forward(params: dict, cfg: dict, tokens) -> torch.Tensor:
    """tokens (S,) -> logits (S, V) float32, with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tokens = torch.as_tensor(tokens)
        table = _f(params["embed"]["table"])
        x = table[tokens] * cfg["embedding_multiplier"]
        eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
        for kind, p in zip(cfg["layer_types"], params["blocks"], strict=True):
            key, mixer = MIXERS[kind]
            x = x + r * mixer(p[key], cfg, rmsnorm(x, p["norm"]["scale"], eps))
            x = x + r * moe(p["moe"], cfg, rmsnorm(x, p["norm2"]["scale"],
                                                   eps))
        x = rmsnorm(x, params["final_norm"]["scale"], eps)
        return x @ table.T / cfg["logits_scaling"]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
