"""Optimizers of the port: AdamW and Adafactor, the reference's formulas
(``repro.train.optim``), applied in place.

These are not ``torch.optim``: the reference's bias correction, its
decoupled weight decay added to the step (scaled by the learning rate),
Adafactor's ``b2 = 1 - (t + 1)^-0.8`` schedule and its update-RMS clip all
differ from torch's.  Every update runs under ``torch.no_grad()`` one leaf
at a time, with float32 temporaries of that leaf only: at 4·10⁹
parameters a second copy of the whole tree does not fit beside the AdamW
moments.  Parameters keep their type (a bf16 weight is updated in float32
and rounded back, as the reference's ``.astype(p.dtype)``).

Trees are the port's parameter dicts: ``params["blocks"]`` (and a VLM's
``params["cross_blocks"]``) is a list of per-layer dicts where the
reference stacks the layers on a leading axis.
Where that stacking changes the result, the functions here reproduce the
stacked one: the global norm is a sum over everything either way, but
Adafactor factors a stacked ``(L, d)`` norm scale across layers and clips
the update's RMS over all layers of a leaf, so its slots for the blocks
keep the reference's stacked layout (:func:`leaf_groups`).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..models.transformer import STACKED


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------
def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a dict / list tree, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def leaves_like(tree, like) -> list[torch.Tensor]:
    """The tensors of ``tree`` in the order of ``tree_leaves(like)``,
    matched by key (dict order may differ between the two)."""
    if isinstance(like, dict):
        return [x for k in like for x in leaves_like(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, lk in zip(tree, like, strict=True)
                for x in leaves_like(t, lk)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on every tensor of a dict / list tree -> a tree of the same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def leaf_groups(tree) -> list[tuple[tuple, list[torch.Tensor]]]:
    """The reference's leaves, as groups of the port's tensors: each leaf
    outside the stacked lists (``transformer.STACKED``) alone, and each
    path inside them with its tensor of every layer (the reference's
    stacked leaf).
    -> [(path, [tensor, ...])]; ``path`` holds the keys, ``"blocks"`` (or
    ``"cross_blocks"``) and then the keys within a block."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if path == () and k in STACKED and isinstance(v, list):
                    for sub in _paths(v[0], ()):
                        out.append(((k, *sub),
                                    [_at(layer, sub) for layer in v]))
                else:
                    walk(v, (*path, k))
        else:
            out.append((path, [node]))

    walk(tree, ())
    return out


def _paths(node, path):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _paths(v, (*path, k))
    else:
        yield path


def _at(node, path):
    for k in path:
        node = node[k]
    return node


# ---------------------------------------------------------------------------
# Schedule and clipping
# ---------------------------------------------------------------------------
def cosine_lr(step: int, *, base_lr: float, warmup: int, total: int,
              min_frac: float = 0.1) -> float:
    """Linear warm-up then cosine decay to ``min_frac * base_lr``, in
    float32 as the reference computes it; -> a Python float (exact: the
    float32 value)."""
    f = torch.float32
    s = torch.tensor(float(step), dtype=f)
    if step < warmup:
        return float(torch.tensor(base_lr, dtype=f) * (s + 1)
                     / max(warmup, 1))
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = torch.tensor(base_lr, dtype=f) * (
        min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(
            torch.tensor(math.pi, dtype=f) * prog)))
    return float(cos)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sum of squares; -> a 0-d
    float32 tensor."""
    total = None
    for x in leaves:
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm_(leaves, max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))`` in
    place (in float32, rounded back to the leaf's type); -> the norm
    before clipping."""
    gn = global_norm(leaves)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for x in leaves:
        if x.dtype == torch.float32:
            x.mul_(scale)
        else:
            x.copy_((x.float() * scale).to(x.dtype))
    return gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params) -> dict:
    """Zero float32 moments with each parameter's placements (a DTensor
    parameter gets a DTensor moment), a zero count."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update_(grads, state: dict, params, *, lr: float,
                  beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1) -> None:
    """One AdamW step in place on ``params`` and ``state`` (``grads`` is a
    list in the order of ``tree_leaves(params)``):
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g²``,
    ``step = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p``,
    ``p -= lr step``."""
    state["count"] += 1
    c = state["count"].float()
    b1c = 1.0 - torch.tensor(beta1, dtype=torch.float32,
                             device=c.device) ** c
    b2c = 1.0 - torch.tensor(beta2, dtype=torch.float32,
                             device=c.device) ** c
    for g, m, v, p in zip(grads, leaves_like(state["m"], params),
                          leaves_like(state["v"], params),
                          tree_leaves(params), strict=True):
        g = g.float()
        m.mul_(beta1).add_(g * (1 - beta1))
        v.mul_(beta2).add_(g.square().mul_(1 - beta2))
        step = (m / b1c).div_((v / b2c).sqrt_().add_(eps))
        pf = p.float()
        step.add_(pf * weight_decay)
        p.copy_(pf.sub_(step.mul_(lr)).to(p.dtype))


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------
def _slot_shape(shape) -> dict:
    if len(shape) >= 2:
        return {"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
    return {"v": shape}


def _slot_placements(p: DTensor, kind: str, stacked: bool) -> list:
    """A DTensor parameter's placements carried to its Adafactor slot: the
    slot keeps the sharding of the axes it keeps (``vr`` drops the last
    axis, ``vc`` the one before it, ``v`` none), shifted by the stacked
    layer axis; a dropped axis's sharding becomes ``Replicate``."""
    n = p.dim()
    gone = {"vr": n - 1, "vc": n - 2}.get(kind)
    out = []
    for pl in p.placements:
        if not isinstance(pl, Shard) or pl.dim == gone:
            out.append(Replicate())
        else:
            d = pl.dim - (1 if gone is not None and pl.dim > gone else 0)
            out.append(Shard(d + int(stacked)))
    return out


def adafactor_init(params) -> dict:
    """Slots of the reference's leaves: ``{"vr", "vc"}`` for a leaf of two
    or more axes (the blocks' leaves stacked: ``(L, *shape)``), else
    ``{"v"}``; nested as the parameters, with ``"blocks"`` (and
    ``"cross_blocks"``) one dict of stacked slots as in the reference.  A
    DTensor parameter's slots are DTensors on its mesh
    (:func:`_slot_placements`)."""
    slots: dict = {}
    for path, group in leaf_groups(params):
        shape = tuple(group[0].shape)
        stacked = path[0] in STACKED
        if stacked:
            shape = (len(group), *shape)
        node = slots
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = {}
        for k, s in _slot_shape(shape).items():
            z = torch.zeros(s, dtype=torch.float32, device=group[0].device)
            if isinstance(group[0], DTensor):
                z = distribute_tensor(
                    z, group[0].device_mesh,
                    _slot_placements(group[0], k, stacked),
                    src_data_rank=None)
            node[path[-1]][k] = z
    dev = tree_leaves(params)[0].device
    return {"slots": slots,
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _factored_update(g, vr, vc):
    """The preconditioned update of one (factored) leaf from its new row /
    column moments."""
    rfac = vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
    pre = rfac[..., None] * vc[..., None, :]
    return g * torch.rsqrt(torch.clamp(pre, min=1e-30))


@torch.no_grad()
def adafactor_update_(grads, state: dict, params, *, lr: float,
                      beta2: float = 0.999, eps: float = 1e-30,
                      weight_decay: float = 0.0,
                      clip_threshold: float = 1.0) -> None:
    """One Adafactor step in place (the reference's ``adafactor_update``;
    ``beta2`` is unused there too: the schedule ``1 - (t + 1)^-0.8``
    replaces it).  A block leaf of two or more axes is updated one layer at
    a time in two passes — the moments and the update's sum of squares,
    then the update clipped by the RMS over all layers — and a block leaf
    of one axis is stacked, as the reference factors it across layers."""
    del beta2
    state["count"] += 1
    c = state["count"].float()
    b2 = 1.0 - (c + 1.0) ** -0.8
    by_id = {id(p): g for g, p in zip(grads, tree_leaves(params),
                                      strict=True)}
    for path, group in leaf_groups(params):
        slot = _at(state["slots"], path)
        gs = [by_id[id(p)] for p in group]
        stacked = path[0] in STACKED
        if stacked and group[0].dim() >= 2:
            n_el, sumsq = 0, None
            for i, g in enumerate(gs):
                g2 = g.float().square().add_(eps)
                slot["vr"][i].mul_(b2).add_((1 - b2) * g2.mean(-1))
                slot["vc"][i].mul_(b2).add_((1 - b2) * g2.mean(-2))
                u = _factored_update(g.float(), slot["vr"][i],
                                     slot["vc"][i])
                sq = u.square().sum()
                sumsq = sq if sumsq is None else sumsq + sq
                n_el += u.numel()
            rms = torch.sqrt(sumsq / n_el + 1e-30)
            div = torch.clamp(rms / clip_threshold, min=1.0)
            for i, (g, p) in enumerate(zip(gs, group, strict=True)):
                u = _factored_update(g.float(), slot["vr"][i],
                                     slot["vc"][i]) / div
                pf = p.float()
                u.add_(pf * weight_decay)
                p.copy_(pf.sub_(u.mul_(lr)).to(p.dtype))
            continue
        p = torch.stack(group) if stacked else group[0]
        g = (torch.stack(gs) if stacked else gs[0]).float()
        g2 = g.square().add_(eps)
        if p.dim() >= 2:
            slot["vr"].mul_(b2).add_((1 - b2) * g2.mean(-1))
            slot["vc"].mul_(b2).add_((1 - b2) * g2.mean(-2))
            u = _factored_update(g, slot["vr"], slot["vc"])
        else:
            slot["v"].mul_(b2).add_((1 - b2) * g2)
            u = g * torch.rsqrt(torch.clamp(slot["v"], min=1e-30))
        rms = torch.sqrt(u.square().mean() + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        pf = p.float()
        u.add_(pf * weight_decay)
        new = pf.sub_(u.mul_(lr)).to(p.dtype)
        if stacked:
            for i, q in enumerate(group):
                q.copy_(new[i])
        else:
            p.copy_(new)


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update_),
    "adafactor": (adafactor_init, adafactor_update_),
}


def make_optimizer(name: str):
    """-> (init, in-place update) of ``"adamw"`` or ``"adafactor"``."""
    try:
        return OPTIMIZERS[name]
    except KeyError as e:
        raise KeyError(f"unknown optimizer {name!r}") from e
