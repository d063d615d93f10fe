"""Mixture-of-Experts layer of the port (``repro.models.moe``): shared and
routed SwiGLU experts behind a top-k router.

Covers qwen2-moe (4 shared + 60 routed, top-4) and grok-1 (8 routed,
top-2).  The dispatch is the reference's: capacity-based (Switch-style),
sort-based into ``(E, C, D)`` expert buffers, dropped tokens writing
nothing, every expert's products as one batched matmul over all E experts.
No host sync: the buffers have a fixed shape and the drops are a mask.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from .config import ModelConfig
from .layers import (_dt, apply_mlp, batch_placements, dense_init, init_mlp,
                     to_local_as)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """A float32 router, (E, in, out) expert weights N(0, 1/in), and the
    shared experts as one SwiGLU of ``d_ff · n_shared`` (``d_expert ·
    n_shared`` without a ``d_ff``)."""
    dt = _dt(cfg, "param")
    e, d, dff = cfg.n_experts, cfg.d_model, cfg.d_expert

    def ew(i, o):
        w = torch.randn((e, i, o), generator=gen, device=gen.device)
        return (w / math.sqrt(i)).to(dt)

    p = {"router": dense_init(gen, d, e, torch.float32),
         "w_gate": ew(d, dff), "w_up": ew(d, dff), "w_down": ew(dff, d)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=(cfg.d_ff or cfg.d_expert)
                               * cfg.n_shared_experts)
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
    SwiGLU as batched products."""
    e, c, d = xe.shape
    g = F.silu(torch.bmm(xe, p["w_gate"].to(cdt)))
    u = torch.bmm(xe, p["w_up"].to(cdt))
    return torch.bmm(g * u, p["w_down"].to(cdt)).reshape(e * c, d)


def _apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
               experts=_experts, shared: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux loss); ``experts(p, buffers, cdt)`` runs
    the routed experts, ``shared`` adds the shared ones.

    The router in float32: softmax, top-k, the k gates renormalised.  The
    T·K (token, expert) pairs are sorted stably by expert; a pair's rank
    within its expert past ``capacity = max(int(capacity_factor·T·K/E),
    4)`` drops it.  Kept tokens are copied into the ``(E, C, D)`` buffers,
    the experts run as batched matmuls, and each token's K gated outputs
    are added one after another in ascending-expert order — the order of
    the reference's sequential scatter-add, rounding in the compute type
    after each add (a scatter-add on the card adds them in no fixed
    order).  The aux loss is Switch's ``E · Σ_e mean_prob_e ·
    top1_share_e``."""
    b, s, d = x.shape
    cdt = _dt(cfg, "compute")
    e, k_top = cfg.n_experts, cfg.moe_top_k
    n_tok = b * s
    tk = n_tok * k_top
    xt = x.reshape(n_tok, d)
    dev = x.device

    logits = xt.float() @ p["router"]                      # (T, E)
    probs = torch.softmax(logits, -1)
    gate_vals, gate_idx = torch.topk(probs, k_top, -1)     # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # load-balancing aux loss (Switch): E * sum(mean prob * top-1 share);
    # taken before the experts: a remat recompute stops after the last
    # tensor the backward needs, and taken last the aux kept it running
    # through the shared experts' output product, which the reference's
    # recompute leaves out
    top1 = (gate_idx[:, :1] == torch.arange(e, device=dev)).float()
    aux = e * torch.sum(probs.mean(0) * top1.mean(0))

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
    by_expert = torch.sort(gate_idx, -1).indices           # (T, K)
    contrib = contrib[inv].reshape(n_tok, k_top, d)
    contrib = contrib.gather(1, by_expert[..., None].expand(-1, -1, d))
    out = contrib[:, 0]
    for j in range(1, k_top):
        out = out + contrib[:, j]
    out = out.reshape(b, s, d)

    if shared and cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], cfg, x)

    return out, aux
