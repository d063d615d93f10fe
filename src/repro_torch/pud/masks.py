"""Attention-mask composition as PuD bulk-Boolean bit-planes.

The port of ``repro.pud.masks``.  Attention masks are pure Boolean
structure: causal AND document AND sliding-window AND padding.  Each mask
is a packed ``(S, S/32)`` bit-plane built on the engine's device, and the
composition is one many-input AND on the engine (one ``nary_bitwise``
launch on the ``kernel`` backend); the engine meters the bus traffic the
in-DRAM path avoids.  MoE routing masks are the same pattern: one OR over
the top-K one-hot planes per expert.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from .engine import PudEngine


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)


def causal_plane(s: int, device="cuda") -> torch.Tensor:
    """(S, S/32) packed lower-triangular (causal keep) mask."""
    q = _positions(s, device)
    return kops.pack_bits((q[:, None] >= q[None, :]).to(torch.uint8))


def window_plane(s: int, window: int, device="cuda") -> torch.Tensor:
    q = _positions(s, device)
    return kops.pack_bits(((q[:, None] - q[None, :]) < window)
                          .to(torch.uint8))


def document_plane(doc_ids: torch.Tensor) -> torch.Tensor:
    """doc_ids: (S,) segment ids -> same-document keep plane (on the ids'
    device)."""
    return kops.pack_bits((doc_ids[:, None] == doc_ids[None, :])
                          .to(torch.uint8))


def padding_plane(valid: torch.Tensor) -> torch.Tensor:
    """valid: (S,) bool -> keys-valid keep plane."""
    s = valid.shape[0]
    return kops.pack_bits(valid.to(torch.uint8)[None, :].expand(s, s))


def compose_mask_planes(engine: PudEngine,
                        planes: list[torch.Tensor]) -> torch.Tensor:
    """Many-input AND over mask planes — one in-DRAM op per 16 planes."""
    if len(planes) == 1:
        return planes[0]
    return engine.nary(torch.stack(planes), "and")


def compose_attention_mask(engine: PudEngine, s: int, *, window: int = 0,
                           doc_ids=None, valid=None) -> torch.Tensor:
    """-> (S, S) bool keep-mask composed on the PuD engine (on its
    device)."""
    dev = engine.device
    planes = [causal_plane(s, dev)]
    if window:
        planes.append(window_plane(s, window, dev))
    if doc_ids is not None:
        planes.append(document_plane(torch.as_tensor(doc_ids, device=dev)))
    if valid is not None:
        planes.append(padding_plane(torch.as_tensor(valid, device=dev)))
    packed = compose_mask_planes(engine, planes)
    return kops.unpack_bits(packed)[:, :s].bool()


def route_mask_planes(engine: PudEngine, gate_idx,
                      n_experts: int) -> torch.Tensor:
    """MoE dispatch masks as bit-planes: gate_idx (T, K) -> per-expert
    packed token masks (E, T/32) via OR over the K one-hot planes."""
    gate_idx = torch.as_tensor(gate_idx, device=engine.device)
    t, k = gate_idx.shape
    pad = (-t) % 32
    planes = []
    for i in range(k):
        oh = torch.nn.functional.one_hot(gate_idx[:, i].long(), n_experts) \
            .to(torch.uint8).T                          # (E, T)
        planes.append(kops.pack_bits(torch.nn.functional.pad(oh, (0, pad))))
    if len(planes) == 1:
        return planes[0]
    return engine.nary(torch.stack(planes), "or")
