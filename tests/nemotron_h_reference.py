"""A plain float32 forward of NVIDIA Nemotron 3 Nano 30B-A3B (``nemotron_h``):
tokens to logits, one sequence, no cache, no batching, no kernel.

It imports nothing of the port and no JAX: plain ``torch`` operations on
the port's parameter tree (the weights under test), every weight cast to
float32 at use, with TF32 off for the products (set inside :func:`forward`
and restored after).  The configuration is a dict of the published
``config.json``'s keys (``hybrid_override_pattern``, ``hidden_size``,
``mamba_num_heads``, ``n_groups``, ``n_routed_experts``, ...).

The layer equations (``x`` the residual stream):

* every layer: ``x = x + mixer(rmsnorm(x))``; after the last layer a final
  ``rmsnorm`` and the untied ``lm_head``; ``norm_eps`` from the config;
* ``*`` attention: ``q, k, v = h·Wq, h·Wk, h·Wv`` (no bias), query head
  ``i`` reading kv head ``i // (H / KV)``, causal softmax of ``q·k /
  sqrt(hd)``, no positional embedding, then ``·Wo``;
* ``M`` Mamba-2: ``h·W_in`` split into ``z, x, B, C, dt`` (widths
  ``d_inner, d_inner, G·N, G·N, heads``); a causal depthwise conv of width
  ``conv_kernel`` with bias over ``[x, B, C]`` (zeros before the first
  token), SiLU; ``dt = softplus(dt + dt_bias)``, ``A = −exp(A_log)``; the
  recurrence, one token after another, ``S_h ← exp(dt_h A_h) S_h + dt_h ·
  B_g ⊗ x_h`` and ``y_h = C_g · S_h + D_h x_h`` with ``g = h // (heads /
  G)``; ``y = rmsnorm_g(y · silu(z)) · w`` over ``G`` slices of
  ``d_inner``; then ``·W_out``;
* ``E`` MoE: ``s = sigmoid(h·Wr)``; the top ``k`` experts by ``s + b``;
  weights ``s`` there over their sum plus 1e-20, times
  ``routed_scaling_factor``; each expert ``down(relu(up(h))²)``; the
  weighted sum plus the shared expert's ``down(relu(up(h))²)``.

Departures from the published model: random weights (the port's
``init_params``); the state recurrence written token by token (the
published kernels use the chunked scan, the same function).

The parameter tree (the port's): ``embed.table`` (V, D), ``unembed.table``
(V, D), ``final_norm.scale``; ``blocks[i]`` ``{"norm": {"scale"}, mixer}``
with the mixer ``attn`` (``wq`` (D, H·hd), ``wk``, ``wv`` (D, KV·hd), ``wo``
(H·hd, D)), ``ssm`` (``w_in`` (D, 2·di + 2·G·N + heads), ``conv_w`` (kw,
C), ``conv_b`` (C,), ``a_log``, ``dt_bias``, ``d_skip`` (heads,),
``norm.scale`` (di,), ``w_out`` (di, D)) or ``moe`` (``router`` (D, E),
``router_bias`` (E,), ``w_up`` (E, F, D), ``w_down`` (E, D, F),
``shared.w_up`` (D, Fs), ``shared.w_down`` (Fs, D)).
"""
from __future__ import annotations

import math

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
    hd = cfg["head_dim"]
    q = (h @ _f(p["wq"])).reshape(s, nh, hd)
    k = (h @ _f(p["wk"])).reshape(s, kvh, hd)
    v = (h @ _f(p["wv"])).reshape(s, kvh, hd)
    rep = nh // kvh
    k = k.repeat_interleave(rep, 1)
    v = v.repeat_interleave(rep, 1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return out.reshape(s, nh * hd) @ _f(p["wo"])


def mamba(p: dict, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    s = h.shape[0]
    nh, hd = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    g, n = cfg["n_groups"], cfg["ssm_state_size"]
    di = nh * hd
    kw = cfg["conv_kernel"]
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
    y = (y * torch.rsqrt(y.square().mean(-1, keepdim=True) + cfg["norm_eps"])
         ).reshape(s, di) * _f(p["norm"]["scale"])
    return y @ _f(p["w_out"])


def route(p: dict, cfg: dict, h: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (weights (S, k), experts (S, k))."""
    scores = torch.sigmoid(h @ _f(p["router"]))
    choice = scores + _f(p["router_bias"])
    idx = torch.topk(choice, cfg["num_experts_per_tok"], -1).indices
    w = scores.gather(-1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    return w, idx


def relu2(h: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
    return torch.relu(h @ _f(up)).square() @ _f(down)


def moe(p: dict, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    w, idx = route(p, cfg, h)
    out = torch.zeros_like(h)
    for t in range(h.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            out[t] += w[t, j] * relu2(h[t], p["w_up"][e].T,
                                      p["w_down"][e].T)
    return out + relu2(h, p["shared"]["w_up"], p["shared"]["w_down"])


MIXERS = {"*": ("attn", attention), "M": ("ssm", mamba), "E": ("moe", moe)}


def forward(params: dict, cfg: dict, tokens) -> torch.Tensor:
    """tokens (S,) -> logits (S, V) float32, with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        tokens = torch.as_tensor(tokens)
        x = _f(params["embed"]["table"][tokens])
        eps = cfg["norm_eps"]
        for c, p in zip(cfg["hybrid_override_pattern"], params["blocks"],
                        strict=True):
            key, mixer = MIXERS[c]
            x = x + mixer(p[key], cfg, rmsnorm(x, p["norm"]["scale"], eps))
        x = rmsnorm(x, params["final_norm"]["scale"], eps)
        return x @ _f(params["unembed"]["table"]).T
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
