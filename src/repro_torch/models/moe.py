"""Mixture-of-Experts layer of the port (``repro.models.moe``): shared and
routed experts behind a top-k router.

Covers qwen2-moe (4 shared + 60 routed, top-4) and grok-1 (8 routed,
top-2): SwiGLU experts, a softmax router, and the reference's dispatch —
capacity-based (Switch-style), sort-based into ``(E, C, D)`` expert
buffers, dropped tokens writing nothing, every expert's products as one
batched matmul over all E experts.  No host sync: the buffers have a fixed
shape and the drops are a mask.

Nemotron-H and Granite 4.0-H (the port's own, ``capacity_factor = 0``)
take the dropless dispatch: every (token, expert) pair computed — the
pairs sorted stably by expert, the per-expert offsets counted on the
device, and one grouped product over the sorted rows (a CUDA kernel on the
card, a loop over the experts with rows on the CPU); no host read, so the
layer is captured in the decode step's CUDA graph.  Every expert has its
own rows there, so a token's output does not depend on the other tokens of
the batch.  Nemotron-H: a sigmoid router with a score-correction bias that
picks the top k (the weights are the plain scores, renormalised, times
``routed_scaling``) and relu² experts (two matrices, no gate;
:func:`repro_torch.kernels.moe_grouped.grouped_experts`).  Granite 4.0-H:
the softmax router and SwiGLU experts whose gate and up are one matrix,
``w_gate_up`` (E, 2F, D), the gate rows first (its ``input_linear``;
:func:`repro_torch.kernels.moe_grouped.grouped_experts_swiglu`), the
shared expert likewise one ``w_gate_up`` (D, 2F).

While a profile records (:mod:`repro_torch.trace`), an eager call runs its
parts inside ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` spans; a CUDA graph replay opens none.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from .. import trace
from ..kernels import moe_grouped
from .config import ModelConfig
from .layers import (_dt, apply_mlp, batch_placements, dense_init, init_mlp,
                     to_local_as)


#: the expert choices of the MoE calls while :func:`recording` is open
_routes: list | None = None

#: the sigmoid router's score-correction bias: N(0, ROUTER_BIAS_STD²) draws,
#: small beside the scores' spread, yet enough to change some choices
ROUTER_BIAS_STD = 0.01


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """A float32 router, expert weights N(0, 1/in), and the shared experts
    as one MLP of ``d_ff · n_shared`` (``d_expert · n_shared`` without a
    ``d_ff``).  SwiGLU experts: (E, in, out) each; relu² experts have no
    gate and take the published layout, K-major, as the grouped kernel
    reads it: ``w_up`` (E, F, D), ``w_down`` (E, D, F); dropless SwiGLU
    experts take Granite's, K-major too: ``w_gate_up`` (E, 2F, D), the gate
    rows first, and ``w_down`` (E, D, F), with the shared experts' gate and
    up one ``w_gate_up`` (D, 2F).  A sigmoid router
    has a float32 score-correction bias ``router_bias`` (E,),
    N(0, ``ROUTER_BIAS_STD``²)."""
    dt = _dt(cfg, "param")
    e, d, dff = cfg.n_experts, cfg.d_model, cfg.d_expert
    fused = cfg.mlp_act != "relu2" and cfg.capacity_factor == 0
    kmajor = cfg.mlp_act == "relu2" or fused

    def ew(i, o):
        shape = (e, o, i) if kmajor else (e, i, o)
        w = torch.randn(shape, generator=gen, device=gen.device)
        return (w / math.sqrt(i)).to(dt)

    p = {"router": dense_init(gen, d, e, torch.float32)}
    if fused:
        p.update(w_gate_up=ew(d, 2 * dff), w_down=ew(dff, d))
    else:
        if cfg.mlp_act != "relu2":
            p["w_gate"] = ew(d, dff)
        p.update(w_up=ew(d, dff), w_down=ew(dff, d))
    if cfg.router == "sigmoid":
        p["router_bias"] = ROUTER_BIAS_STD * torch.randn(
            (e,), generator=gen, device=gen.device)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=(cfg.d_ff or cfg.d_expert)
                               * cfg.n_shared_experts, fused=fused)
    return p


def apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux loss); on a mesh see
    :func:`_apply_moe_sharded`."""
    if isinstance(x, DTensor):
        return _apply_moe_sharded(p, cfg, x)
    return _apply_moe(p, cfg, x)


def _apply_moe_sharded(p: dict, cfg: ModelConfig, x: DTensor):
    """The layer on a mesh.  The dispatch (``topk``, a stable ``sort``, a
    ``cumsum``, ``index_copy`` and ``gather`` over every token of the
    global batch, whose capacity and drops depend on all of them) has no
    DTensor sharding rule that keeps the one-device result, so every rank
    routes and combines all the tokens, gathered, on local tensors; the
    experts' products run as DTensor products on the ``(E, C, D)``
    buffers with the expert weights where the sharding rules put them, and
    the shared experts on the DTensor input.  Each rank keeps its batch
    rows of the output."""
    mesh = x.device_mesh
    full = [Replicate()] * mesh.ndim

    def experts(_p, xe, cdt):
        xe = DTensor.from_local(xe, mesh, full, run_check=False)
        return to_local_as(_experts(p, xe, cdt), mesh, full)

    out, aux = _apply_moe({"router": to_local_as(p["router"], mesh, full)},
                          cfg, to_local_as(x, mesh, full), experts=experts,
                          shared=False)
    out = DTensor.from_local(out, mesh, full, run_check=False).redistribute(
        mesh, batch_placements(mesh, x.shape[0]))
    if cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], cfg, x)
    return out, DTensor.from_local(aux, mesh, full, run_check=False)


def _experts(p: dict, xe: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """(E, C, D) expert buffers -> (E·C, D) outputs: every expert's
    SwiGLU (relu² where the experts have no gate) as batched products."""
    e, c, d = xe.shape
    if "w_gate_up" in p:                   # SwiGLU, (E, 2F, D): gate, up
        g, u = torch.bmm(xe, p["w_gate_up"].to(cdt).transpose(1, 2)) \
            .chunk(2, -1)
        return torch.bmm(F.silu(g) * u, p["w_down"].to(cdt).transpose(1, 2)) \
            .reshape(e * c, d)
    if "w_gate" not in p:                  # relu²: (E, out, in) weights
        u = torch.bmm(xe, p["w_up"].to(cdt).transpose(1, 2))
        return torch.bmm(torch.relu(u).square(),
                         p["w_down"].to(cdt).transpose(1, 2)) \
            .reshape(e * c, d)
    u = torch.bmm(xe, p["w_up"].to(cdt))
    g = F.silu(torch.bmm(xe, p["w_gate"].to(cdt)))
    return torch.bmm(g * u, p["w_down"].to(cdt)).reshape(e * c, d)


def route(p: dict, cfg: ModelConfig, xt: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router in float32: (T, D) -> (gate weights (T, K) float32,
    expert ids (T, K), aux loss).  Softmax: top k of the probabilities,
    renormalised; aux is Switch's ``E · Σ_e mean_prob_e · top1_share_e``.
    Sigmoid: scores ``s = sigmoid(x·Wr)``, the top k by ``s + b`` (the
    score-correction bias), the weights ``s`` at
    those experts over their sum plus 1e-20, times ``routed_scaling``; aux
    0 (the served model has no training loss here)."""
    logits = xt.float() @ p["router"]                      # (T, E)
    k_top = cfg.moe_top_k
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        choice = scores + p["router_bias"]
        gate_idx = torch.topk(choice, k_top, -1).indices
        w = scores.gather(-1, gate_idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling
        return w, gate_idx, torch.zeros((), device=xt.device)
    probs = torch.softmax(logits, -1)
    gate_vals, gate_idx = torch.topk(probs, k_top, -1)     # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # load-balancing aux loss (Switch): E * sum(mean prob * top-1 share);
    # taken before the experts: a remat recompute stops after the last
    # tensor the backward needs, and taken last the aux kept it running
    # through the shared experts' output product, which the reference's
    # recompute leaves out
    e = cfg.n_experts
    top1 = (gate_idx[:, :1] == torch.arange(e, device=xt.device)).float()
    aux = e * torch.sum(probs.mean(0) * top1.mean(0))
    return gate_vals, gate_idx, aux


@contextlib.contextmanager
def recording():
    """Keep each MoE call's expert choice — the (T, K) expert ids its
    router picked — in call order: -> the list they go to.  Under CUDA
    graph capture they are the graph's own buffers, which every replay
    rewrites (no copy, no host read)."""
    global _routes
    saved, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = saved


def _sum_by_expert(contrib: torch.Tensor, gate_idx: torch.Tensor
                   ) -> torch.Tensor:
    """(T, K, D) pair outputs in (token, k) order -> (T, D): each token's K
    outputs added one after another in ascending-expert order, rounding in
    their type after each add (the reference's sequential scatter-add)."""
    d = contrib.shape[-1]
    by_expert = torch.sort(gate_idx, -1).indices           # (T, K)
    contrib = contrib.gather(1, by_expert[..., None].expand(-1, -1, d))
    out = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return out


def _dropless(p: dict, cfg: ModelConfig, xt: torch.Tensor,
              gate_vals: torch.Tensor, gate_idx: torch.Tensor,
              cdt: torch.dtype) -> torch.Tensor:
    """Every (token, expert) pair through its expert: (T, D) -> (T, D).
    The T·K pairs sorted stably by expert, the (E + 1,) offsets counted on
    the device, one grouped product over the sorted rows (SwiGLU where the
    experts hold ``w_gate_up``, relu² otherwise), then each pair's
    weighted output back in (token, k) order and summed per token in
    ascending-expert order."""
    n_tok, d = xt.shape
    k_top, e = cfg.moe_top_k, cfg.n_experts
    tk = n_tok * k_top
    with trace.span("moe.dispatch"):
        expert_flat = gate_idx.reshape(tk)
        order = torch.sort(expert_flat, stable=True).indices
        counts = torch.zeros(e + 1, dtype=torch.int32, device=xt.device) \
            .scatter_add_(0, expert_flat + 1,
                          torch.ones_like(expert_flat, dtype=torch.int32))
        offsets = torch.cumsum(counts, 0, dtype=torch.int32)
        xs = xt.to(cdt)[order // k_top]
    with trace.span("moe.experts"):
        if "w_gate_up" in p:
            ys = moe_grouped.grouped_experts_swiglu(
                xs, offsets, p["w_gate_up"].to(cdt), p["w_down"].to(cdt))
        else:
            ys = moe_grouped.grouped_experts(xs, offsets, p["w_up"].to(cdt),
                                             p["w_down"].to(cdt))
    with trace.span("moe.combine"):
        w = gate_vals.reshape(tk)[order][:, None].to(cdt)
        contrib = torch.empty_like(ys).index_copy_(0, order, ys * w)
        return _sum_by_expert(contrib.reshape(n_tok, k_top, d), gate_idx)


def _apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
               experts=_experts, shared: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux loss); ``experts(p, buffers, cdt)`` runs
    the routed experts of the capacity path, ``shared`` adds the shared
    ones.  The router: :func:`route`.  ``capacity_factor`` 0: the dropless
    dispatch (:func:`_dropless`).  Otherwise the T·K (token, expert) pairs
    are sorted stably by expert; a pair's rank within its expert past
    ``capacity = max(int(capacity_factor·T·K/E), 4)`` drops it.  Kept
    tokens are copied into the ``(E, C, D)`` buffers, the experts run as
    batched matmuls, and each token's K gated outputs are added one after
    another in ascending-expert order — the order of the reference's
    sequential scatter-add, rounding in the compute type after each add (a
    scatter-add on the card adds them in no fixed order)."""
    b, s, d = x.shape
    cdt = _dt(cfg, "compute")
    n_tok = b * s
    xt = x.reshape(n_tok, d)
    with trace.span("moe.route"):
        gate_vals, gate_idx, aux = route(p, cfg, xt)
    if _routes is not None:
        _routes.append(gate_idx)
    if cfg.capacity_factor > 0:
        out = _capacity(p, cfg, xt, gate_vals, gate_idx, cdt, experts)
    else:
        out = _dropless(p, cfg, xt, gate_vals, gate_idx, cdt)
    out = out.reshape(b, s, d)
    if shared and cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], cfg, x)
    return out, aux


def _capacity(p: dict, cfg: ModelConfig, xt: torch.Tensor,
              gate_vals: torch.Tensor, gate_idx: torch.Tensor,
              cdt: torch.dtype, experts) -> torch.Tensor:
    """The reference's capacity dispatch: (T, D) -> (T, D), pairs past an
    expert's capacity dropped."""
    n_tok, d = xt.shape
    e, k_top = cfg.n_experts, cfg.moe_top_k
    tk = n_tok * k_top
    dev = xt.device
    capacity = max(int(cfg.capacity_factor * n_tok * k_top / e), 4)
    expert_flat = gate_idx.reshape(tk)
    token_flat = torch.arange(n_tok, device=dev).repeat_interleave(k_top)
    # stable sort by expert; the rank within an expert = index - offset
    order = torch.sort(expert_flat, stable=True).indices
    e_sorted = expert_flat[order]
    # a fixed-size count (``bincount``'s size depends on the data, which
    # fake tensors cannot give)
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, expert_flat, torch.ones_like(expert_flat))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=dev) - offsets[e_sorted]
    keep = pos < capacity
    dest = e_sorted * capacity + torch.clamp(pos, max=capacity - 1)
    keep_c = keep[:, None].to(cdt)
    # copy the kept tokens into the expert buffers; dropped ones go to a
    # spare row past the end
    rows = torch.where(keep, dest, e * capacity)
    xe = torch.zeros((e * capacity + 1, d), dtype=cdt, device=dev) \
        .index_copy(0, rows, xt.to(cdt)[token_flat[order]] * keep_c)
    ye = experts(p, xe[:-1].reshape(e, capacity, d), cdt)
    # each pair's gated output, back in (token, k) order, then summed per
    # token in ascending-expert order
    contrib = ye[dest] * (gate_vals.reshape(tk)[order][:, None].to(cdt)
                          * keep_c)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(tk, device=dev)
    return _sum_by_expert(contrib[inv].reshape(n_tok, k_top, d), gate_idx)
