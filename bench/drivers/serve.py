"""Traffic kind ``serve``: a served model behind the program's engine.

``setup`` draws the weights on the device from the run's seed — the
reference's own draw (``bench/reference/nemotron_h.py``
:class:`~bench.reference.nemotron_h.Weights`: the published checkpoint's
layout, one part at a time), loaded into the program's parameter tree
(:func:`load_program`) — and builds one ``ServeEngine`` of the
deployment's slots and length, which captures the decode step's CUDA
graph.  A call draws its requests from its own seed (:func:`requests`: the
mix's count, prompts log-uniform on ``[prompt_min, prompt_max]`` with ids
uniform over the vocabulary, answers uniform on ``[new_min, new_max]``
tokens, greedy), submits them all at once and runs the engine until every
one has finished; its answer is each request's tokens.

The judgement, for each drawn call: ``judged_requests`` of its requests,
drawn from its seed (:func:`judged`); the call run again by the program
with their logits and expert choices kept (the prefill's last row and
every decode step's logits; each MoE layer's experts at every position
fed), its tokens held to the window's answer (``rerun_mismatch``: requests
whose tokens differ, or calls that failed, limit 0); then the plain
float32 reference on each judged request's prompt and emitted tokens, on
weights it draws again from the seed, following the program's expert
choice: at a near tie in a router's biased scores the program's rounding
may pick another expert, and the reference takes that choice with its own
weights, counting it as a routing flip.  ``routing_flip_share``: flips
over the MoE layers' positions; at each judged position ``‖program −
reference‖₂ / ‖reference‖₂``, whose quantiles over all of them are
``logit_rel_err_p50`` and ``logit_rel_err_p99``; and ``greedy_mismatch``
counts the positions whose emitted token is not the reference's argmax
although the reference's top-2 gap exceeds twice the position's largest
logit error (there the program's own argmax must be the reference's),
limit 0.  The limits and their readings: :data:`LIMITS`.

The control (``control()``) is the reference with the operands of every
matrix product rounded to float8 e4m3 (one scale a tensor), below the
configuration's bf16, in the program's place, on the same draw (held in
memory: no program beside it): it answers only the judged requests of a
call (the others it leaves empty), greedily, one full forward a token;
its logits and expert choices are those of its own forwards.
"""
from __future__ import annotations

import math
import random
import sys

import numpy as np
import torch

from bench.reference import nemotron_h as reference

#: each number compared and its limit, from H100 readings at the cell's
#: traffic, full size (two calls of seed 7100000001, 4 requests each;
#: PERF.md §2), the reference following the program's expert choice.
#: ``logit_rel_err_p50``: the program 0.0261, the float8 control 0.770;
#: under a fault: ``experts_dropped`` 0.168, ``ssm_state_reset`` 0.752.
#: ``logit_rel_err_p99``: the program 0.0291, the control 1.058; faults
#: 1.039 and 0.902.  ``routing_flip_share`` (flips over the MoE layers'
#: positions): the program 0.132 (bf16 rounding tipping near ties), the
#: control 0.738, ``experts_dropped`` 0.734.  Each limit lies about 3×
#: above the program (2.3× for the flips) and at least 2.5× below the
#: control.  At the CPU tests' float32 sizes the program reads ~4e-7 and no
#: flip, the control 0.12 / 0.51 / 0.083.  ``greedy_mismatch`` (95 under
#: ``token_altered``) and ``rerun_mismatch``: exact.
LIMITS = {"logit_rel_err_p50": 0.08, "logit_rel_err_p99": 0.1,
          "routing_flip_share": 0.3, "greedy_mismatch": 0,
          "rerun_mismatch": 0}
#: the CPU tests' configuration and mix: every layer kind, groups > 1,
#: experts > top-k, at widths a CPU serves in a fraction of a second
SMALL_CONFIG = {
    "hybrid_override_pattern": "MEM*E", "num_hidden_layers": 5,
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 16, "mamba_num_heads": 4, "mamba_head_dim": 16,
    "n_groups": 2, "ssm_state_size": 16, "chunk_size": 16,
    "n_routed_experts": 8, "num_experts_per_tok": 2,
    "moe_intermediate_size": 32, "moe_shared_expert_intermediate_size": 64,
    "vocab_size": 512}
SMALL_DEPLOYMENT = {"n_slots": 3, "max_len": 64}
SMALL_MIX = {"requests": 4, "prompt_min": 16, "prompt_max": 48, "new_min": 6,
             "new_max": 10, "judged_requests": 2}


def model_config(cfg: dict):
    """The program's config of the configuration file: the registry's
    (``arch``) with the file's published sizes in place, so that a file cut
    for the CPU tests gives the cut model and the full file the registry's
    own (``reduced`` is empty)."""
    from repro_torch.configs import get_config
    return get_config(cfg["arch"]).replace(
        n_layers=cfg["num_hidden_layers"],
        layer_pattern=cfg["hybrid_override_pattern"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["moe_shared_expert_intermediate_size"],
        vocab=cfg["vocab_size"], n_experts=cfg["n_routed_experts"],
        moe_top_k=cfg["num_experts_per_tok"],
        d_expert=cfg["moe_intermediate_size"],
        routed_scaling=cfg["routed_scaling_factor"],
        ssm_state=cfg["ssm_state_size"], ssm_n_heads=cfg["mamba_num_heads"],
        ssm_head_dim=cfg["mamba_head_dim"], ssm_groups=cfg["n_groups"],
        ssm_conv=cfg["conv_kernel"], ssm_chunk=cfg["chunk_size"],
        norm_eps=cfg["norm_eps"], param_dtype=cfg["dtype"],
        compute_dtype=cfg["dtype"])


def requests(cfg: dict, mix: dict, seed: int) -> list[tuple[list, int]]:
    """A call's requests from its seed: (prompt ids, new tokens) each."""
    rng = np.random.default_rng(seed % 2 ** 63)
    n = mix["requests"]
    lens = np.exp(rng.uniform(math.log(mix["prompt_min"]),
                              math.log(mix["prompt_max"]), n)).astype(int)
    new = rng.integers(mix["new_min"], mix["new_max"] + 1, n)
    return [(rng.integers(0, cfg["vocab_size"], int(s)).tolist(), int(k))
            for s, k in zip(lens, new, strict=True)]


def judged(mix: dict, seed: int) -> list[int]:
    """The requests of a call that its judgement compares."""
    return sorted(random.Random(seed ^ 0x5E7E).sample(
        range(mix["requests"]), mix["judged_requests"]))


def load_program(weights: reference.Weights, mc) -> dict:
    """The program's parameter tree (``transformer.init_params``'s keys)
    from the reference's draw, a part at a time: a projection ``(out, in)``
    becomes the program's ``(in, out)`` (a copy), the stacked experts stay
    ``(E, out, in)`` as they are (the grouped kernel's layout)."""
    def t(w):
        return w.T.contiguous()

    blocks = []
    for i, kind in enumerate(mc.layer_pattern):
        p = weights.part(i)
        if kind == "*":
            mixer = {"attn": {"wq": t(p["q_proj"]), "wk": t(p["k_proj"]),
                              "wv": t(p["v_proj"]), "wo": t(p["o_proj"])}}
        elif kind == "M":
            mixer = {"ssm": {"w_in": t(p["in_proj"]), "conv_w": t(p["conv_w"]),
                             "conv_b": p["conv_b"], "a_log": p["A_log"],
                             "dt_bias": p["dt_bias"], "d_skip": p["D"],
                             "norm": {"scale": p["gnorm"]},
                             "w_out": t(p["out_proj"])}}
        else:
            mixer = {"moe": {"router": t(p["gate"]),
                             "router_bias": p["e_score_correction_bias"],
                             "w_up": p["up"], "w_down": p["down"],
                             "shared": {"w_up": t(p["shared_up"]),
                                        "w_down": t(p["shared_down"])}}}
        blocks.append({"norm": {"scale": p["norm"]}, **mixer})
    head = weights.part(weights.n_layers + 1)
    return {"blocks": blocks,
            "embed": {"table": weights.part(weights.n_layers)[
                "embed_tokens"]},
            "final_norm": {"scale": head["norm_f"]},
            "unembed": {"table": head["lm_head"]}}


# ---------------------------------------------------------------------------
# faults: the timed path broken underneath the driver
# ---------------------------------------------------------------------------
def token_altered(monkeypatch) -> None:
    """Every token the engine reads from a decode step comes back +1."""
    from repro_torch.serve import graph
    run = graph.DecodeGraph.run

    def altered(self, tokens, positions):
        logits, nxt = run(self, tokens, positions)
        return logits, (nxt + 1) % logits.shape[-1]

    monkeypatch.setattr(graph.DecodeGraph, "run", altered)


def experts_dropped(monkeypatch) -> None:
    """The MoE dispatch at capacity factor 1.0: pairs past an expert's
    capacity dropped."""
    from repro_torch.models import moe

    def capped(p, cfg, xt, gate_vals, gate_idx, cdt):
        return moe._capacity(p, cfg.replace(capacity_factor=1.0), xt,
                             gate_vals, gate_idx, cdt, moe._experts)

    monkeypatch.setattr(moe, "_dropless", capped)


def ssm_state_reset(monkeypatch) -> None:
    """The first Mamba layer's decode step reads a zero state."""
    from repro_torch.models import ssm
    apply = ssm.apply_ssm
    first: list = []

    def reset(p, cfg, u, *, ssm_cache=None, valid=None):
        if ssm_cache is not None and u.shape[1] == 1:
            if not first:
                first.append(p)
            if p is first[0]:
                ssm_cache["state"].zero_()
        return apply(p, cfg, u, ssm_cache=ssm_cache, valid=valid)

    monkeypatch.setattr(ssm, "apply_ssm", reset)


class Serve:
    """The program behind its engine, or (``control``) the float8
    reference in its place."""

    faults = (token_altered, experts_dropped, ssm_state_reset)

    def __init__(self, control: bool = False):
        self.is_control = control
        self.weights = None
        self.params = None
        self.engine = None
        self._answers: dict[int, tuple[list, dict, dict]] = {}

    def setup(self, cfg, mix, seed, device) -> None:
        self.weights = reference.Weights(cfg, seed, device,
                                         keep=self.is_control)
        if not self.is_control:
            from repro_torch.serve.engine import ServeEngine
            mc = model_config(cfg)
            self.params = load_program(self.weights, mc)
            dep = cfg["deployment"]
            self.engine = ServeEngine(
                mc, self.params, n_slots=dep["n_slots"],
                max_len=dep["max_len"],
                cache_dtype=getattr(torch, dep["cache_dtype"]), device=device)

    # ------------------------------------------------------------------
    def _serve(self, cfg, mix, seed, keep=()) -> tuple[list, dict, dict]:
        """The call through the engine: -> (tokens a request, logits (n, V)
        and expert choices (MoE layers, positions, k) of the requests at
        indices ``keep``)."""
        eng = self.engine
        eng.finished, eng.prefill_s, eng.decode_s = [], [], []
        eng.logits, eng.routes = {}, {}
        rids = [eng.submit(p, max_new_tokens=k)
                for p, k in requests(cfg, mix, seed)]
        eng.keep_logits = {rids[j] for j in keep} if keep else None
        by_rid = {r.rid: r.out_tokens for r in eng.run()}
        eng.keep_logits = None
        return ([by_rid[r] for r in rids],
                {j: torch.stack(eng.logits[rids[j]]) for j in keep},
                {j: torch.cat(eng.routes[rids[j]], 1) for j in keep})

    def _generate(self, cfg, mix, seed) -> tuple[list, dict, dict]:
        """The control's call: the judged requests, greedy, through the
        float8 reference, one full forward a token; the expert choices
        those of the last forward (every position fed)."""
        if seed not in self._answers:
            reqs = requests(cfg, mix, seed)
            tokens = [[] for _ in reqs]
            logits, routes = {}, {}
            for j in judged(mix, seed):
                seq, rows = list(reqs[j][0]), []
                for _ in range(reqs[j][1]):
                    (row,), (routes[j],), _n = reference.forward(
                        self.weights, [seq], [[len(seq) - 1]],
                        rounding=reference.round_fp8)
                    rows.append(row[0].cpu())
                    seq.append(int(row[0].argmax()))
                tokens[j] = seq[len(reqs[j][0]):]
                logits[j] = torch.stack(rows)
            self._answers[seed] = (tokens, logits, routes)
        return self._answers[seed]

    def call(self, cfg, mix, seed, device) -> list:
        if self.is_control:
            return self._generate(cfg, mix, seed)[0]
        return self._serve(cfg, mix, seed)[0]

    def _rerun(self, cfg, mix, seed) -> tuple[list, dict, dict]:
        if self.is_control:
            return self._generate(cfg, mix, seed)
        return self._serve(cfg, mix, seed, keep=judged(mix, seed))

    def judge(self, cfg, mix, calls, device, log=sys.stderr) -> dict:
        errs, mismatch, rerun_bad, flips, routed = [], 0, 0, 0, 0
        n_moe = cfg["hybrid_override_pattern"].count("E")
        for seed, answer in calls:
            if answer is None:
                rerun_bad += 1
                continue
            tokens, logits, routes = self._rerun(cfg, mix, seed)
            reqs = requests(cfg, mix, seed)
            js = [j for j in judged(mix, seed) if tokens[j] == answer[j]]
            rerun_bad += len(judged(mix, seed)) - len(js)
            if not js:
                continue
            seqs = [reqs[j][0] + answer[j][:-1] for j in js]
            at = [range(len(reqs[j][0]) - 1, len(s)) for j, s in
                  zip(js, seqs, strict=True)]
            wants, _r, n = reference.forward(
                self.weights, seqs, at, follow=[routes[j] for j in js])
            flips += n
            routed += n_moe * sum(len(s) for s in seqs)
            for j, want in zip(js, wants, strict=True):
                out = answer[j]
                got = logits[j].to(want.device)
                diff = got - want
                rel = (diff.norm(dim=-1) / want.norm(dim=-1)).tolist()
                errs += rel
                top2 = want.topk(2, -1).values
                sure = top2[:, 0] - top2[:, 1] > 2 * diff.abs().amax(-1)
                emitted = torch.tensor(out, device=want.device)
                bad = int(((emitted != want.argmax(-1)) & sure).sum())
                mismatch += bad
                print(f"[logits] call {seed} request {j}: "
                      f"{len(reqs[j][0])} + {len(out)} tokens, rel err "
                      f"median {float(np.median(rel)):.6g} max "
                      f"{max(rel):.6g}, greedy mismatches {bad}", file=log)
            print(f"[routing] call {seed}: {n} flips over {n_moe} MoE "
                  f"layers x {sum(len(s) for s in seqs)} positions",
                  file=log)
        inf = float("inf")
        values = {
            "logit_rel_err_p50": float(np.quantile(errs, 0.5)) if errs
            else inf,
            "logit_rel_err_p99": float(np.quantile(errs, 0.99)) if errs
            else inf,
            "routing_flip_share": flips / routed if routed else inf,
            "greedy_mismatch": mismatch, "rerun_mismatch": rerun_bad}
        return {k: {"value": v, "limit": LIMITS[k]}
                for k, v in values.items()}

    def control(self) -> Serve:
        return Serve(control=True)

    def small(self, cfg, mix):
        """The CPU tests' sizes, in float32: there the program agrees with
        the reference to rounding, so a fault in one layer, or the float8
        control, stands out by orders of magnitude."""
        return (dict(cfg, **SMALL_CONFIG, dtype="float32",
                     deployment=dict(cfg["deployment"], **SMALL_DEPLOYMENT)),
                dict(mix, **SMALL_MIX))

    def small_control(self, cfg, mix):
        return self.small(cfg, mix)


DRIVER = Serve()
