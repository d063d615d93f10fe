"""The plain float32 forward of NVIDIA Nemotron 3 Nano 30B-A3B
(``nemotron_h``), on weights it draws itself from the run's seed, computed
in blocks so that it fits on the card beside the program's 58.8 GiB of
weights: the benchmark's copy of ``tests/nemotron_h_reference.py``, the
same equations.

It imports nothing of the program and no JAX, and runs with TF32 off (set
inside :func:`forward`, restored after).  The configuration is the
benchmark's configuration file (the published ``config.json``'s keys).

The weights (:class:`Weights`) are drawn here, in the published
checkpoint's layout (a projection ``(out, in)``, the experts stacked
``(E, out, in)``), one part at a time — the embedding, each layer, the
head — each part from a generator of its own (the seed and the part's
number), so that any part can be drawn again alone: the judge draws each
layer when it reaches it and drops it after, the program is loaded from
the same draws (``bench/drivers/serve.py``).  The draw: every projection
N(0, 1/in), the embeddings N(0, 0.02²), the norms ones, the conv N(0,
1/kw) with its bias N(0, 1/kw), ``A_log = log(linspace(1, 16, heads))``,
``dt_bias`` the inverse softplus of a log-uniform draw on [1e-3, 1e-1],
``D`` ones; the router float32 N(0, 1/in) and its score-correction bias
float32 N(0, 0.01²); the rest in the configuration's ``dtype``.

The equations (``x`` the residual stream), one sequence, no cache:

* every layer ``x = x + mixer(rmsnorm(x))``, then a final ``rmsnorm`` and
  the untied ``lm_head``, taken only at the positions asked for;
* ``*``: GQA (query head ``i`` reads kv head ``i // (H / KV)``), causal
  softmax, no positional embedding;
* ``M``: the projection into ``z, x, B, C, dt``, a causal depthwise conv
  with bias and SiLU, ``dt = softplus(dt + dt_bias)``, ``A = −exp(A_log)``,
  the state recurrence ``S_h ← exp(dt_h A_h) S_h + dt_h B_g ⊗ x_h``, ``y_h
  = C_g · S_h + D_h x_h`` (``g = h // (heads / G)``), the gated RMSNorm
  over ``G`` slices of ``d_inner``, the output projection;
* ``E``: ``s = sigmoid(x·Wr)``, the top ``k`` by ``s + b``, weights ``s``
  over their sum plus 1e-20 times ``routed_scaling_factor``, each expert
  ``down(relu(up(h))²)``, plus the shared expert.

``follow``: the experts the program chose, per MoE layer and position.
Where its own top ``k`` differs from them — a near tie in ``s + b`` that
the program's rounding tipped — the reference takes the program's choice,
with the weights of its own scores, and counts the position as a routing
flip: a flip then costs the logits no more than the rounding that caused
it, and the flips are judged by their own count.

The blocks, each the same function as the plain file's: every layer's
weights drawn (or cast to float32) one layer at a time, the MoE over the
tokens of every sequence at once, the routed experts one expert at a time
over the rows routed to it; attention over blocks of :data:`Q_BLOCK`
queries; the recurrence over chunks of :data:`CHUNK` tokens in its closed
form (within a chunk ``y_i = Σ_{j≤i} (C_i·B_j) exp(Σ_{j<k≤i} dt_k A) dt_j
x_j``, plus ``exp(Σ_{k≤i} dt_k A) C_i · S`` from the state before it; then
the state carried over), a chunk after another.

``rounding``: a function applied to both operands of every matrix product
(the projections, attention's ``q·k`` and ``p·v``, the router, the experts,
the ``lm_head``): the control's precision below the configuration's
(:func:`round_fp8`).  The state recurrence's products stay float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: queries per block of the attention
Q_BLOCK = 1024
#: tokens per chunk of the state recurrence
CHUNK = 64
#: the largest finite float8 e4m3 value
FP8_MAX = 448.0
#: the score-correction bias's draw, N(0, ROUTER_BIAS_STD²)
ROUTER_BIAS_STD = 0.01
#: the embeddings' draw, N(0, EMBED_STD²)
EMBED_STD = 0.02


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor (its
    largest magnitude onto 448), back in float32."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _same(t):
    return t


class Weights:
    """The model's weights from ``seed``, part by part: ``part(i)`` for
    layer ``i``, ``part(L)`` the embedding, ``part(L + 1)`` the head (the
    final norm and ``lm_head``), ``L`` the layers.  ``keep``: hold every
    part once drawn (the control, which runs with no program beside it);
    otherwise each is drawn anew when asked for."""

    def __init__(self, cfg: dict, seed: int, device, keep: bool = False):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.n_layers = len(cfg["hybrid_override_pattern"])
        self.keep = {} if keep else None

    def part(self, i: int) -> dict:
        if self.keep is not None and i in self.keep:
            return self.keep[i]
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1_000_003 + i) % 2 ** 63)
        p = self._draw(i, gen)
        if self.keep is not None:
            self.keep[i] = p
        return p

    def _randn(self, gen, shape, std, dtype=None):
        w = torch.randn(shape, generator=gen, device=self.device) * std
        return w.to(dtype or self.dtype)

    def _dense(self, gen, out: int, inp: int, dtype=None):
        return self._randn(gen, (out, inp), 1 / math.sqrt(inp), dtype)

    def _experts(self, gen, out: int, inp: int):
        """(E, out, in), drawn an expert at a time."""
        w = torch.empty((self.cfg["n_routed_experts"], out, inp),
                        dtype=self.dtype, device=self.device)
        for e in range(w.shape[0]):
            w[e] = self._dense(gen, out, inp)
        return w

    def _draw(self, i: int, gen) -> dict:
        cfg = self.cfg
        d, v = cfg["hidden_size"], cfg["vocab_size"]
        ones = torch.ones((d,), dtype=self.dtype, device=self.device)
        if i == self.n_layers:
            return {"embed_tokens": self._randn(gen, (v, d), EMBED_STD)}
        if i == self.n_layers + 1:
            return {"norm_f": ones,
                    "lm_head": self._randn(gen, (v, d), EMBED_STD)}
        kind = cfg["hybrid_override_pattern"][i]
        if kind == "*":
            hd = cfg["head_dim"]
            q, kv = (cfg["num_attention_heads"] * hd,
                     cfg["num_key_value_heads"] * hd)
            return {"norm": ones, "q_proj": self._dense(gen, q, d),
                    "k_proj": self._dense(gen, kv, d),
                    "v_proj": self._dense(gen, kv, d),
                    "o_proj": self._dense(gen, d, q)}
        if kind == "M":
            nh, kw = cfg["mamba_num_heads"], cfg["conv_kernel"]
            di = nh * cfg["mamba_head_dim"]
            conv = di + 2 * cfg["n_groups"] * cfg["ssm_state_size"]
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt0 = torch.exp(torch.rand((nh,), generator=gen,
                                       device=self.device) * (hi - lo) + lo)
            return {"norm": ones,
                    "in_proj": self._dense(gen, di + conv + nh, d),
                    "conv_w": self._randn(gen, (conv, kw), 1 / math.sqrt(kw)),
                    "conv_b": self._randn(gen, (conv,), 1 / math.sqrt(kw)),
                    "dt_bias": torch.log(torch.expm1(dt0)),
                    "A_log": torch.log(torch.linspace(1, 16, nh,
                                                      device=self.device)),
                    "D": torch.ones((nh,), device=self.device),
                    "gnorm": torch.ones((di,), dtype=self.dtype,
                                        device=self.device),
                    "out_proj": self._dense(gen, d, di)}
        f = cfg["moe_intermediate_size"]
        fs = cfg["moe_shared_expert_intermediate_size"]
        return {"norm": ones,
                "gate": self._dense(gen, cfg["n_routed_experts"], d,
                                    torch.float32),
                "e_score_correction_bias": self._randn(
                    gen, (cfg["n_routed_experts"],), ROUTER_BIAS_STD,
                    torch.float32),
                "up": self._experts(gen, f, d),
                "down": self._experts(gen, d, f),
                "shared_up": self._dense(gen, fs, d),
                "shared_down": self._dense(gen, d, fs)}


class _Forward:
    """One forward's constants: the configuration and the rounding."""

    def __init__(self, cfg: dict, rounding):
        self.cfg = cfg
        self.r = rounding or _same

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (.., in) times a weight (out, in) in the published layout."""
        return self.r(a) @ self.r(w.float()).T

    def rmsnorm(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.cfg["norm_eps"]) * scale.float()

    def attention(self, p, h):
        cfg = self.cfg
        s = h.shape[0]
        nh, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = cfg["head_dim"]
        q = self.mm(h, p["q_proj"]).reshape(s, nh, hd)
        k = self.mm(h, p["k_proj"]).reshape(s, kvh, hd)
        v = self.mm(h, p["v_proj"]).reshape(s, kvh, hd)
        rep = nh // kvh
        k = self.r(k.repeat_interleave(rep, 1)).permute(1, 2, 0)  # (H,hd,S)
        v = self.r(v.repeat_interleave(rep, 1)).permute(1, 0, 2)  # (H,S,hd)
        out = torch.empty(s, nh, hd, device=h.device)
        keys = torch.arange(s, device=h.device)
        for q0 in range(0, s, Q_BLOCK):
            qb = self.r(q[q0:q0 + Q_BLOCK]).permute(1, 0, 2)       # (H,q,hd)
            sc = (qb @ k) / math.sqrt(hd)                          # (H,q,S)
            rows = torch.arange(q0, q0 + qb.shape[1], device=h.device)
            sc = sc.masked_fill(keys[None, None, :] > rows[None, :, None],
                                float("-inf"))
            out[q0:q0 + qb.shape[1]] = (self.r(torch.softmax(sc, -1)) @ v
                                        ).permute(1, 0, 2)
        return self.mm(out.reshape(s, nh * hd), p["o_proj"])

    def mamba(self, p, h):
        cfg = self.cfg
        s = h.shape[0]
        nh, hd = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
        g, n = cfg["n_groups"], cfg["ssm_state_size"]
        di = nh * hd
        kw = cfg["conv_kernel"]
        z, xbc, dt = torch.split(self.mm(h, p["in_proj"]),
                                 [di, di + 2 * g * n, nh], -1)
        pad = torch.cat([torch.zeros(kw - 1, xbc.shape[1], device=h.device),
                         xbc])
        w = p["conv_w"].float()                                 # (C, kw)
        conv = sum(pad[i:i + s] * w[:, i] for i in range(kw)) \
            + p["conv_b"].float()
        xbc = F.silu(conv)
        x, bm, cm = torch.split(xbc, [di, g * n, g * n], -1)
        x = x.reshape(s, nh, hd)
        group = torch.arange(nh, device=h.device) // (nh // g)
        bm = bm.reshape(s, g, n)[:, group]                     # (S,heads,N)
        cm = cm.reshape(s, g, n)[:, group]
        dt = F.softplus(dt + p["dt_bias"].float())              # (S,heads)
        a = -torch.exp(p["A_log"].float())
        d_skip = p["D"].float()
        state = torch.zeros(nh, n, hd, device=h.device)
        y = torch.empty(s, nh, hd, device=h.device)
        for c0 in range(0, s, CHUNK):
            xs, dts = x[c0:c0 + CHUNK], dt[c0:c0 + CHUNK]
            bs, cs = bm[c0:c0 + CHUNK], cm[c0:c0 + CHUNK]
            q = xs.shape[0]
            cum = torch.cumsum(dts * a, 0)                      # (q,heads)
            ii = torch.arange(q, device=h.device)
            past = ii[:, None] >= ii[None, :]
            logd = cum.T[:, :, None] - cum.T[:, None, :]        # (heads,i,j)
            decay = torch.exp(torch.where(past, logd, float("-inf")))
            cb = torch.einsum("ihn,jhn->hij", cs, bs) * decay
            yc = torch.einsum("hij,jhd->ihd", cb, dts[:, :, None] * xs)
            yc = yc + torch.exp(cum)[:, :, None] * torch.einsum(
                "ihn,hnd->ihd", cs, state)
            wgt = torch.exp(cum[-1] - cum) * dts                # (q,heads)
            state = torch.exp(cum[-1])[:, None, None] * state \
                + torch.einsum("jh,jhn,jhd->hnd", wgt, bs, xs)
            y[c0:c0 + q] = yc + d_skip[:, None] * xs
        y = y.reshape(s, di) * F.silu(z)
        y = y.reshape(s, g, di // g)
        y = (y * torch.rsqrt(y.square().mean(-1, keepdim=True)
                             + cfg["norm_eps"])).reshape(s, di) \
            * p["gnorm"].float()
        return self.mm(y, p["out_proj"])

    def relu2(self, h, up, down):
        return self.mm(torch.relu(self.mm(h, up)).square(), down)

    def moe(self, p, h, follow=None):
        """h (T, D) -> (out, the experts taken (T, k), routing flips: rows
        where ``follow`` differs from the reference's own top k)."""
        cfg = self.cfg
        scores = torch.sigmoid(self.mm(h, p["gate"]))
        choice = scores + p["e_score_correction_bias"].float()
        idx = torch.topk(choice, cfg["num_experts_per_tok"], -1).indices
        flips = 0
        if follow is not None:
            follow = follow.to(idx.device, torch.int64)
            flips = int((idx.sort(-1).values
                         != follow.sort(-1).values).any(-1).sum())
            idx = follow
        w = scores.gather(-1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) \
            * cfg["routed_scaling_factor"]
        out = torch.zeros_like(h)
        for e in torch.unique(idx).tolist():
            tok, j = (idx == e).nonzero(as_tuple=True)
            y = self.relu2(h[tok], p["up"][e], p["down"][e])
            out.index_add_(0, tok, w[tok, j][:, None] * y)
        out = out + self.relu2(h, p["shared_up"], p["shared_down"])
        return out, idx, flips


def forward(weights: Weights, seqs: list, at: list, rounding=None,
            follow: list | None = None
            ) -> tuple[list[torch.Tensor], list[torch.Tensor], int]:
    """Each token list of ``seqs`` through the model -> (float32 logits
    (len(at[j]), V) at the positions ``at[j]`` of each, the experts each
    took (MoE layers, S, k), routing flips in all), with TF32 off.
    ``follow[j]``: the experts the program took for sequence ``j``, (MoE
    layers, S, k), or None."""
    cfg = weights.cfg
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            f = _Forward(cfg, rounding)
            dev = weights.device
            table = weights.part(weights.n_layers)["embed_tokens"]
            xs = [table[torch.as_tensor(s, device=dev)].float() for s in seqs]
            del table
            lens = [len(s) for s in seqs]
            routes: list[list[torch.Tensor]] = [[] for _ in seqs]
            flips, n_moe = 0, 0
            for i, kind in enumerate(cfg["hybrid_override_pattern"]):
                p = weights.part(i)
                hs = [f.rmsnorm(x, p["norm"]) for x in xs]
                if kind == "E":
                    fol = None if follow is None else torch.cat(
                        [fw[n_moe] for fw in follow])
                    out, idx, n = f.moe(p, torch.cat(hs), fol)
                    flips += n
                    n_moe += 1
                    outs = out.split(lens)
                    for r, part in zip(routes, idx.split(lens), strict=True):
                        r.append(part)
                else:
                    mixer = f.attention if kind == "*" else f.mamba
                    outs = [mixer(p, h) for h in hs]
                xs = [x + o for x, o in zip(xs, outs, strict=True)]
                del p, hs, outs
            head = weights.part(weights.n_layers + 1)
            logits = [f.mm(f.rmsnorm(x[torch.as_tensor(a, device=dev)],
                                     head["norm_f"]), head["lm_head"])
                      for x, a in zip(xs, at, strict=True)]
            return logits, [torch.stack(r) for r in routes], flips
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
