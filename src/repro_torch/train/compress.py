"""int8 gradient compression with error feedback (``repro.train.compress``,
bit for bit).

One round per leaf: ``x = g + err`` in float32, a symmetric per-leaf scale
``max(max|x| / 127, 1e-12)``, ``q = clip(round(x / scale), -127, 127)`` as
int8 (round half to even, as ``jnp.round``), the dequantized ``q * scale``
becomes the gradient and ``x - q * scale`` the next residual.  A leaf is
the reference's: the blocks' tensors of one path share one scale over all
layers, as the reference's stacked leaf does (``optim.leaf_groups``).
The residual tree mirrors the parameters and is updated in place.
"""
from __future__ import annotations

import torch

from .optim import leaf_groups, leaves_like, tree_leaves, tree_map


def ef_init(params):
    """Zero float32 residuals shaped and placed as the parameters."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, float32 scale): symmetric per-tensor quantization."""
    return _quantize(x, _scale(x.abs().max()))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.div(amax, torch.tensor(
        127.0, dtype=torch.float32, device=amax.device)), min=1e-12)


def _quantize(x: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(torch.div(x, scale)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round: -> (dequantized gradient, new residual)."""
    x = g.to(torch.float32) + err
    deq = dequantize_int8(*quantize_int8(x))
    return deq, x - deq


@torch.no_grad()
def tree_compress_decompress_(grads: list, errs, params) -> list:
    """One round over every leaf of the reference (a block path's layers
    share one scale): -> the dequantized float32 gradients, in the order of
    ``grads`` (that of ``tree_leaves(params)``); ``errs`` is updated in
    place.  The layers of a block path are taken one at a time, twice
    (their largest magnitude, then the round), so nothing of the size of
    the stacked leaf is made."""
    index = {id(p): i for i, p in enumerate(tree_leaves(params))}
    err_at = leaves_like(errs, params)
    out = [None] * len(grads)
    for _path, group in leaf_groups(params):
        idx = [index[id(p)] for p in group]
        amax = None
        for i in idx:
            m = (grads[i].to(torch.float32) + err_at[i]).abs().max()
            amax = m if amax is None else torch.maximum(amax, m)
        scale = _scale(amax)
        for i in idx:
            x = grads[i].to(torch.float32) + err_at[i]
            deq = dequantize_int8(*_quantize(x, scale))
            err_at[i].copy_(x - deq)
            out[i] = deq
    return out
