"""The plain float32 forward of IBM Granite 4.0-H Small (``granitemoehybrid``),
on weights it draws itself from the run's seed, computed in blocks so that
it fits on the card beside the program's 60 GiB of weights: the
benchmark's copy of ``tests/granite_hybrid_reference.py``, the same
equations.

It imports nothing of the program and no JAX, and runs with TF32 off (set
inside :func:`forward`, restored after).  The configuration is the
benchmark's configuration file (the published ``config.json``'s keys).

The weights (:class:`Weights`) are drawn here, in the published
checkpoint's layout (a projection ``(out, in)``; the experts' stacked
``input_linear`` (E, 2F, D), gate rows first, and ``output_linear`` (E, D,
F); the shared expert's ``input_linear`` (2Fs, D) and ``output_linear`` (D,
Fs); the unembedding tied to the embedding), one part at a time — the
embedding, each layer, the final norm — each part from a generator of its
own (the seed and the part's number), so that any part can be drawn again
alone: the judge draws each layer when it reaches it and drops it after,
the program is loaded from the same draws
(``bench/drivers/serve_granite.py``).  The draw: every projection N(0,
1/in), the embedding N(0, 0.02²), the norms ones, the conv N(0, 1/kw) with
its bias N(0, 1/kw), ``A_log = log(linspace(1, 16, heads))``, ``dt_bias``
the inverse softplus of a log-uniform draw on [1e-3, 1e-1], ``D`` ones;
the router float32 N(0, 1/in); the rest in the configuration's ``dtype``.

The equations (``x`` the residual stream, ``r`` the
``residual_multiplier``), one sequence, no cache:

* ``x = embedding_multiplier · embed(tokens)``;
* every layer ``x = x + r · mixer(rmsnorm₁(x))``, then ``x = x + r ·
  (moe(rmsnorm₂(x)) + shared(rmsnorm₂(x)))``; then a final ``rmsnorm`` and
  the tied unembedding over ``logits_scaling``, taken only at the
  positions asked for;
* ``attention``: GQA (query head ``i`` reads kv head ``i // (H / KV)``),
  causal softmax of ``q·k · attention_multiplier``, no positional
  embedding;
* ``mamba``: the projection into ``z, x, B, C, dt``, a causal depthwise
  conv with bias and SiLU, ``dt = softplus(dt + dt_bias)`` (no clamp:
  ``time_step_limit`` (0, ∞)), ``A = −exp(A_log)``, the state recurrence
  ``S_h ← exp(dt_h A_h) S_h + dt_h B_g ⊗ x_h``, ``y_h = C_g · S_h + D_h x_h``
  (``g = h // (heads / G)``), the gated RMSNorm over ``G`` slices of
  ``d_inner`` (one for Granite), the output projection;
* MoE: the router logits ``h · Wr``, the top ``k``, the softmax over those
  ``k``; each expert ``down(silu(g) · u)``, ``[g, u]`` the halves of its
  ``input_linear``'s product; plus the shared expert the same way.

Departures from the published model: random weights; the recurrence in
its chunked closed form (below); the router's ``k`` weights kept float32
(the published code casts them to the activations' type before
combining); everything in float32.

``follow``: the experts the program chose, per layer and position.  Where
its own top ``k`` differs from them — a near tie in the router's logits
that the program's rounding tipped — the reference takes the program's
choice, with the softmax over its own logits at those experts, and counts
the position as a routing flip: a flip then costs the logits no more than
the rounding that caused it, and the flips are judged by their own count.

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
the unembedding): the control's precision below the configuration's
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
#: the embedding's draw, N(0, EMBED_STD²)
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
    layer ``i``, ``part(L)`` the embedding, ``part(L + 1)`` the final norm,
    ``L`` the layers.  ``keep``: hold every part once drawn (the control,
    which runs with no program beside it); otherwise each is drawn anew
    when asked for."""

    def __init__(self, cfg: dict, seed: int, device, keep: bool = False):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.n_layers = len(cfg["layer_types"])
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
        w = torch.empty((self.cfg["num_local_experts"], out, inp),
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
            return {"norm_f": ones}
        if cfg["layer_types"][i] == "attention":
            hd = d // cfg["num_attention_heads"]
            q, kv = (cfg["num_attention_heads"] * hd,
                     cfg["num_key_value_heads"] * hd)
            p = {"q_proj": self._dense(gen, q, d),
                 "k_proj": self._dense(gen, kv, d),
                 "v_proj": self._dense(gen, kv, d),
                 "o_proj": self._dense(gen, d, q)}
        else:
            nh, kw = cfg["mamba_n_heads"], cfg["mamba_d_conv"]
            di = nh * cfg["mamba_d_head"]
            conv = di + 2 * cfg["mamba_n_groups"] * cfg["mamba_d_state"]
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt0 = torch.exp(torch.rand((nh,), generator=gen,
                                       device=self.device) * (hi - lo) + lo)
            p = {"in_proj": self._dense(gen, di + conv + nh, d),
                 "conv_w": self._randn(gen, (conv, kw), 1 / math.sqrt(kw)),
                 "conv_b": self._randn(gen, (conv,), 1 / math.sqrt(kw)),
                 "dt_bias": torch.log(torch.expm1(dt0)),
                 "A_log": torch.log(torch.linspace(1, 16, nh,
                                                   device=self.device)),
                 "D": torch.ones((nh,), device=self.device),
                 "gnorm": torch.ones((di,), dtype=self.dtype,
                                     device=self.device),
                 "out_proj": self._dense(gen, d, di)}
        f, fs = cfg["intermediate_size"], cfg["shared_intermediate_size"]
        p.update(norm=ones, norm2=ones.clone(),
                 router=self._dense(gen, cfg["num_local_experts"], d,
                                    torch.float32),
                 input_linear=self._experts(gen, 2 * f, d),
                 output_linear=self._experts(gen, d, f),
                 shared_input=self._dense(gen, 2 * fs, d),
                 shared_output=self._dense(gen, d, fs))
        return p


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
                               + self.cfg["rms_norm_eps"]) * scale.float()

    def attention(self, p, h):
        cfg = self.cfg
        s = h.shape[0]
        nh, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = cfg["hidden_size"] // nh
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
            sc = (qb @ k) * cfg["attention_multiplier"]             # (H,q,S)
            rows = torch.arange(q0, q0 + qb.shape[1], device=h.device)
            sc = sc.masked_fill(keys[None, None, :] > rows[None, :, None],
                                float("-inf"))
            out[q0:q0 + qb.shape[1]] = (self.r(torch.softmax(sc, -1)) @ v
                                        ).permute(1, 0, 2)
        return self.mm(out.reshape(s, nh * hd), p["o_proj"])

    def mamba(self, p, h):
        cfg = self.cfg
        s = h.shape[0]
        nh, hd = cfg["mamba_n_heads"], cfg["mamba_d_head"]
        g, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
        di = nh * hd
        kw = cfg["mamba_d_conv"]
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
        bm = bm.reshape(s, g, n)
        cm = cm.reshape(s, g, n)
        dt = F.softplus(dt + p["dt_bias"].float())              # (S,heads)
        a = -torch.exp(p["A_log"].float())
        d_skip = p["D"].float()
        state = torch.zeros(nh, n, hd, device=h.device)
        y = torch.empty(s, nh, hd, device=h.device)
        for c0 in range(0, s, CHUNK):
            xs, dts = x[c0:c0 + CHUNK], dt[c0:c0 + CHUNK]
            bs = bm[c0:c0 + CHUNK][:, group]                    # (q,heads,N)
            cs = cm[c0:c0 + CHUNK][:, group]
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
                             + cfg["rms_norm_eps"])).reshape(s, di) \
            * p["gnorm"].float()
        return self.mm(y, p["out_proj"])

    def swiglu(self, h, gate_up, down):
        g, u = self.mm(h, gate_up).chunk(2, -1)
        return self.mm(F.silu(g) * u, down)

    def moe(self, p, h, follow=None):
        """h (T, D) -> (out, the experts taken (T, k), routing flips: rows
        where ``follow`` differs from the reference's own top k)."""
        cfg = self.cfg
        logits = self.mm(h, p["router"])
        idx = torch.topk(logits, cfg["num_experts_per_tok"], -1).indices
        flips = 0
        if follow is not None:
            follow = follow.to(idx.device, torch.int64)
            flips = int((idx.sort(-1).values
                         != follow.sort(-1).values).any(-1).sum())
            idx = follow
        w = torch.softmax(logits.gather(-1, idx), -1)
        out = torch.zeros_like(h)
        for e in torch.unique(idx).tolist():
            tok, j = (idx == e).nonzero(as_tuple=True)
            y = self.swiglu(h[tok], p["input_linear"][e],
                            p["output_linear"][e])
            out.index_add_(0, tok, w[tok, j][:, None] * y)
        out = out + self.swiglu(h, p["shared_input"], p["shared_output"])
        return out, idx, flips


def forward(weights: Weights, seqs: list, at: list, rounding=None,
            follow: list | None = None
            ) -> tuple[list[torch.Tensor], list[torch.Tensor], int]:
    """Each token list of ``seqs`` through the model -> (float32 logits
    (len(at[j]), V) at the positions ``at[j]`` of each, the experts each
    took (layers, S, k), routing flips in all), with TF32 off.
    ``follow[j]``: the experts the program took for sequence ``j``,
    (layers, S, k), or None."""
    cfg = weights.cfg
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            f = _Forward(cfg, rounding)
            dev = weights.device
            r = cfg["residual_multiplier"]
            table = weights.part(weights.n_layers)["embed_tokens"]
            xs = [table[torch.as_tensor(s, device=dev)].float()
                  * cfg["embedding_multiplier"] for s in seqs]
            lens = [len(s) for s in seqs]
            routes: list[list[torch.Tensor]] = [[] for _ in seqs]
            flips = 0
            for i, kind in enumerate(cfg["layer_types"]):
                p = weights.part(i)
                mixer = f.attention if kind == "attention" else f.mamba
                xs = [x + r * mixer(p, f.rmsnorm(x, p["norm"])) for x in xs]
                fol = None if follow is None else torch.cat(
                    [fw[i] for fw in follow])
                out, idx, n = f.moe(
                    p, torch.cat([f.rmsnorm(x, p["norm2"]) for x in xs]), fol)
                flips += n
                xs = [x + r * o for x, o in
                      zip(xs, out.split(lens), strict=True)]
                for rt, part in zip(routes, idx.split(lens), strict=True):
                    rt.append(part)
                del p, out
            head = weights.part(weights.n_layers + 1)
            logits = [f.mm(f.rmsnorm(x[torch.as_tensor(a, device=dev)],
                                     head["norm_f"]), table)
                      / cfg["logits_scaling"]
                      for x, a in zip(xs, at, strict=True)]
            return logits, [torch.stack(rt) for rt in routes], flips
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
