"""Traffic kind ``serve_granite``: IBM Granite 4.0-H Small behind the
program's engine, as ``serve`` serves Nemotron 3 Nano
(``bench/drivers/serve.py``): the same calls, the same requests
(:func:`~bench.drivers.serve.requests`), the same judged requests
(:func:`~bench.drivers.serve.judged`), the same numbers compared and the
same faults; the weights, the reference and the control are Granite's
(``bench/reference/granite_hybrid.py``).

``setup`` draws the weights on the device from the run's seed — the
reference's own draw (:class:`~bench.reference.granite_hybrid.Weights`:
the published checkpoint's layout, one part at a time) — loads them into
the program's parameter tree (:func:`load_program`) and builds one
``ServeEngine`` of the deployment's slots and length, which captures the
decode step's CUDA graph.  A call submits its requests all at once and
runs the engine until every one has finished; its answer is each
request's tokens.

The judgement, for each drawn call: its judged requests run again by the
program with their logits and expert choices kept, their tokens held to
the window's answer (``rerun_mismatch``); then the plain float32
reference on each judged request's prompt and emitted tokens, on weights
it draws again from the seed, following the program's expert choice (a
differing choice counted as a routing flip: ``routing_flip_share``, flips
over every layer's positions, each layer a MoE); ``logit_rel_err_p50`` /
``_p99``, the quantiles of ``‖program − reference‖₂ / ‖reference‖₂`` over
the judged positions; ``greedy_mismatch``, the emitted tokens that are not
the reference's argmax where its top-2 gap exceeds twice the position's
largest logit error.  The limits and their readings: :data:`LIMITS`.

The control (``control()``) is the reference with the operands of every
matrix product rounded to float8 e4m3, in the program's place, on the same
draw held in memory (no program beside it): it answers only the judged
requests of a call, greedily, one full forward a token.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from bench.drivers.serve import (Serve, experts_dropped, judged, requests,
                                 token_altered)
from bench.reference import granite_hybrid as reference

#: each number compared and its limit, from H100 readings at the cell's
#: traffic, full size (8 runs, 2 calls of 4 requests each; PERF.md §2), the
#: reference following the program's expert choice.
#: ``logit_rel_err_p50``: the program 0.0363-0.0375, the float8 control
#: 0.290; under a fault: ``experts_dropped`` 0.222, ``ssm_state_reset``
#: 1.057.  ``logit_rel_err_p99``: the program 0.0400-0.0431, the control
#: 0.308; faults 0.391 and 1.157.  ``routing_flip_share`` (flips over every
#: layer's positions): the program 0.2124-0.2184 (bf16 rounding tipping the
#: tenth and eleventh of 72 logits), the control 0.851, ``experts_dropped``
#: 0.433.  The logit limits lie about 2.8-2.9x above the program and 2.6x
#: below the control; the flips' 1.5x above (a reading over ~10^5 routed
#: positions, steady to 0.006 across seeds) and 2.6x below.
#: ``greedy_mismatch`` (143 under ``token_altered``) and ``rerun_mismatch``:
#: exact.
LIMITS = {"logit_rel_err_p50": 0.11, "logit_rel_err_p99": 0.12,
          "routing_flip_share": 0.33, "greedy_mismatch": 0,
          "rerun_mismatch": 0}
#: the CPU tests' configuration and mix: both mixer kinds (Mamba-2 leading,
#: as in the published pattern, so that a lost SSM state shows), one SSM
#: group, experts > top-k, a shared expert, at widths a CPU serves in a
#: fraction of a second
SMALL_CONFIG = {
    "layer_types": ["mamba", "mamba", "attention", "mamba", "mamba"],
    "num_hidden_layers": 5, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "mamba_n_heads": 4, "mamba_d_head": 16,
    "mamba_n_groups": 1, "mamba_d_state": 16, "mamba_chunk_size": 16,
    "num_local_experts": 8, "num_experts_per_tok": 3,
    "intermediate_size": 32, "shared_intermediate_size": 64,
    "vocab_size": 512}
SMALL_DEPLOYMENT = {"n_slots": 3, "max_len": 64}
SMALL_MIX = {"requests": 4, "prompt_min": 16, "prompt_max": 48, "new_min": 6,
             "new_max": 10, "judged_requests": 2}
#: the program's layer kind of each published ``layer_types`` entry
KINDS = {"mamba": "M", "attention": "*"}


def model_config(cfg: dict):
    """The program's config of the configuration file: the registry's
    (``arch``) with the file's published sizes in place, so that a file cut
    for the CPU tests gives the cut model and the full file the registry's
    own (``reduced`` is empty)."""
    from repro_torch.configs import get_config
    return get_config(cfg["arch"]).replace(
        n_layers=cfg["num_hidden_layers"],
        layer_pattern="".join(KINDS[t] for t in cfg["layer_types"]),
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        d_ff=cfg["shared_intermediate_size"], vocab=cfg["vocab_size"],
        n_experts=cfg["num_local_experts"],
        moe_top_k=cfg["num_experts_per_tok"],
        d_expert=cfg["intermediate_size"],
        ssm_state=cfg["mamba_d_state"], ssm_n_heads=cfg["mamba_n_heads"],
        ssm_head_dim=cfg["mamba_d_head"], ssm_groups=cfg["mamba_n_groups"],
        ssm_conv=cfg["mamba_d_conv"], ssm_chunk=cfg["mamba_chunk_size"],
        norm_eps=cfg["rms_norm_eps"],
        embedding_multiplier=cfg["embedding_multiplier"],
        residual_multiplier=cfg["residual_multiplier"],
        logits_scaling=cfg["logits_scaling"],
        attn_scale=cfg["attention_multiplier"],
        tie_embeddings=cfg["tie_word_embeddings"],
        param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"])


def load_program(weights: reference.Weights, mc) -> dict:
    """The program's parameter tree (``transformer.init_params``'s keys)
    from the reference's draw, a part at a time: a projection ``(out, in)``
    becomes the program's ``(in, out)`` (a copy); the stacked experts stay
    as they are, ``(E, 2F, D)`` and ``(E, D, F)`` (the grouped kernel's
    layout); the unembedding is the embedding's table."""
    def t(w):
        return w.T.contiguous()

    blocks = []
    for i, kind in enumerate(mc.layer_pattern):
        p = weights.part(i)
        if kind == "*":
            mixer = {"attn": {"wq": t(p["q_proj"]), "wk": t(p["k_proj"]),
                              "wv": t(p["v_proj"]), "wo": t(p["o_proj"])}}
        else:
            mixer = {"ssm": {"w_in": t(p["in_proj"]), "conv_w": t(p["conv_w"]),
                             "conv_b": p["conv_b"], "a_log": p["A_log"],
                             "dt_bias": p["dt_bias"], "d_skip": p["D"],
                             "norm": {"scale": p["gnorm"]},
                             "w_out": t(p["out_proj"])}}
        blocks.append({
            "norm": {"scale": p["norm"]}, **mixer,
            "norm2": {"scale": p["norm2"]},
            "moe": {"router": t(p["router"]), "w_gate_up": p["input_linear"],
                    "w_down": p["output_linear"],
                    "shared": {"w_gate_up": t(p["shared_input"]),
                               "w_down": t(p["shared_output"])}}})
    return {"blocks": blocks,
            "embed": {"table": weights.part(weights.n_layers)[
                "embed_tokens"]},
            "final_norm": {"scale": weights.part(weights.n_layers + 1)[
                "norm_f"]}}


def ssm_state_reset(monkeypatch) -> None:
    """Every Mamba layer's decode step reads a zero state (one layer's
    alone, ``serve``'s fault, moves Granite's logits little at the CPU
    size: each sub-layer's output enters the stream times 0.22)."""
    from repro_torch.models import ssm
    apply = ssm.apply_ssm

    def reset(p, cfg, u, *, ssm_cache=None, valid=None):
        if ssm_cache is not None and u.shape[1] == 1:
            ssm_cache["state"].zero_()
        return apply(p, cfg, u, ssm_cache=ssm_cache, valid=valid)

    monkeypatch.setattr(ssm, "apply_ssm", reset)


class ServeGranite(Serve):
    """The program behind its engine, or (``control``) the float8
    reference in its place; the calls, reruns and answers as ``Serve``'s."""

    faults = (token_altered, experts_dropped, ssm_state_reset)

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

    def judge(self, cfg, mix, calls, device, log=sys.stderr) -> dict:
        errs, mismatch, rerun_bad, flips, routed = [], 0, 0, 0, 0
        n_moe = len(cfg["layer_types"])
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
                diff = logits[j].to(want.device) - want
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

    def control(self) -> ServeGranite:
        return ServeGranite(control=True)

    def small(self, cfg, mix):
        """The CPU tests' sizes, in float32: there the program agrees with
        the reference to rounding, so a fault in one layer, or the float8
        control, stands out by orders of magnitude."""
        return (dict(cfg, **SMALL_CONFIG, dtype="float32",
                     deployment=dict(cfg["deployment"], **SMALL_DEPLOYMENT)),
                dict(mix, **SMALL_MIX))

    def small_control(self, cfg, mix):
        return self.small(cfg, mix)


DRIVER = ServeGranite()
