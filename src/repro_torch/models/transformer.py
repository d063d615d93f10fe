"""Config-driven decoder of the port (``repro.models.transformer``): every
architecture family of the reference — attention, MoE, SSM, hybrid
(parallel attention + SSM), the audio decoder's ``input_embeds`` and the
VLM's cross-attention blocks — for serving and training.

Parameters are plain dicts as in the reference, with the blocks as a
Python list (one dict per layer) where the reference stacks them on a
leading layer axis for ``lax.scan``; the scan becomes a loop over layers.
A VLM's cross blocks are a second list, ``params["cross_blocks"]``, one per
super-block of ``cross_attn_every − 1`` self blocks and one cross block.
Caches are a list of per-self-block dicts — ``{"kv": {"k", "v", "pos"}}``
for attention, ``{"ssm": {"state", "conv"}}`` for SSM, both for hybrid —
updated in place by :func:`decode_step` (and by a prefill into them).

Without a cache, each block (a VLM: each super-block) runs under the
reference's remat policy (:func:`remat_wrap`, ``cfg.remat``) when autograd
records: ``"block"`` / ``"full"`` recompute the whole block in the
backward (``torch.utils.checkpoint``), ``"block_dots"`` saves the matrix
products' outputs and recomputes the rest; serving (a cache) takes no
wrapper.  The MoE blocks' aux losses are summed and discarded, as the
reference's ``forward`` does.

Entry points:
  init_params(gen, cfg)                  -> parameter dict
  forward(params, cfg, batch)            -> logits (prefill, no cache)
  loss_fn(params, cfg, batch)            -> (loss, metrics)
  decode_step(params, cfg, tokens, caches, positions, image_embeds=)
                                         -> (logits, caches)
  init_caches(cfg, batch, s_max)         -> per-layer caches
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .config import ModelConfig
from .layers import _dt


# ---------------------------------------------------------------------------
# Block = norm -> mixer (attention | ssm | hybrid) -> norm -> MoE | SwiGLU
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt, dev = _dt(cfg, "param"), gen.device
    p: dict = {"norm1": L.init_rmsnorm(cfg.d_model, dt, dev)}
    if cfg.block_type in ("attention", "hybrid"):
        p["attn"] = L.init_attention(gen, cfg)
    if cfg.block_type in ("ssm", "hybrid"):
        p["ssm"] = SSM.init_ssm(gen, cfg)
    if cfg.block_type == "hybrid":
        p["attn_out_norm"] = L.init_rmsnorm(cfg.d_model, dt, dev)
        p["ssm_out_norm"] = L.init_rmsnorm(cfg.d_model, dt, dev)
    if cfg.moe:
        p["norm2"] = L.init_rmsnorm(cfg.d_model, dt, dev)
        p["moe"] = MOE.init_moe(gen, cfg)
    elif cfg.d_ff:
        p["norm2"] = L.init_rmsnorm(cfg.d_model, dt, dev)
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def apply_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, cache: dict | None = None,
                extra_mask: torch.Tensor | None = None,
                valid: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """-> (x_out, cache, aux loss), the cache updated in place.  ``valid``
    (a right-padded prefill's (B, S) mask) goes to the SSM only, as the
    reference engine's prefill passes it; a hybrid block adds the mean of
    its two normed mixers."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    new_cache: dict | None = None if cache is None else {}
    if cfg.block_type in ("attention", "hybrid"):
        a, kvc = L.apply_attention(p["attn"], cfg, h, positions,
                                   kv_cache=None if cache is None
                                   else cache["kv"], extra_mask=extra_mask)
        if cache is not None:
            new_cache["kv"] = kvc
    if cfg.block_type in ("ssm", "hybrid"):
        s_out, ssc = SSM.apply_ssm(p["ssm"], cfg, h,
                                   ssm_cache=None if cache is None
                                   else cache["ssm"], valid=valid)
        if cache is not None:
            new_cache["ssm"] = ssc
    if cfg.block_type == "attention":
        x = x + a
    elif cfg.block_type == "ssm":
        x = x + s_out
    else:  # hybrid: parallel attention + SSM heads, mean-combined (Hymba)
        a = L.rmsnorm(p["attn_out_norm"], a, cfg.norm_eps)
        s_out = L.rmsnorm(p["ssm_out_norm"], s_out, cfg.norm_eps)
        x = x + 0.5 * (a + s_out)
    if cfg.moe:
        h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        m, aux = MOE.apply_moe(p["moe"], cfg, h2)
        x = x + m
    elif cfg.d_ff:
        h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.apply_mlp(p["mlp"], cfg, h2)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
#: the top-level keys whose lists of blocks the reference stacks on a layer
#: axis (it initialises them with ``vmap``); the port keeps one dict each
STACKED = ("blocks", "cross_blocks")


def n_cross_blocks(cfg: ModelConfig) -> int:
    """The cross blocks of a VLM (one per super-block), else 0; the other
    ``n_layers − n_cross_blocks`` layers are self blocks."""
    return cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every else 0


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device, with the reference's
    distributions: dense N(0, 1/in), embedding N(0, 0.02²), norms ones
    (MoE and SSM: theirs).  Drawn self block by self block, then the
    embedding(s), then the cross blocks: not the reference's numbers (jax
    keys are not a torch generator)."""
    dt = _dt(cfg, "param")
    n_self = cfg.n_layers - n_cross_blocks(cfg)
    p = {"blocks": [init_block(gen, cfg) for _ in range(n_self)],
         "embed": L.init_embedding(gen, cfg),
         "final_norm": L.init_rmsnorm(cfg.d_model, dt, gen.device)}
    if not cfg.tie_embeddings:
        p["unembed"] = {"table": L.init_embedding(gen, cfg)["table"]}
    if cfg.cross_attn_every:
        p["cross_blocks"] = [
            {"norm": L.init_rmsnorm(cfg.d_model, dt, gen.device),
             "xattn": L.init_cross_attention(gen, cfg)}
            for _ in range(n_cross_blocks(cfg))]
    return p


#: the matrix products whose outputs ``remat="block_dots"`` saves (the
#: reference's ``dots_with_no_batch_dims_saveable``: the projections; the
#: attention's own products are inside the fused region's kernels)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(_ctx, op, *_args, **_kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(cfg: ModelConfig, fn):
    """The reference's ``_remat_wrap``: ``"block"`` / ``"full"`` recompute
    everything of ``fn`` in the backward, ``"block_dots"`` saves the matrix
    products' outputs and recomputes the elementwise work, ``"none"``
    saves everything."""
    if cfg.remat in ("block", "full"):
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "block_dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    if cfg.remat != "none":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    return fn


def run_blocks(params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, caches: list[dict] | None = None, *,
               image_embeds: torch.Tensor | None = None,
               extra_mask: torch.Tensor | None = None,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every block (the reference's scan), then the final norm: -> (x, the
    summed MoE aux loss, which the callers drop as the reference's
    ``forward`` does).  A VLM interleaves super-blocks: ``cross_attn_every
    − 1`` self blocks, then one cross block over ``image_embeds``.  Without
    caches and with autograd recording, each block (super-block) runs under
    :func:`remat_wrap`."""
    remat = caches is None and torch.is_grad_enabled()
    blocks = params["blocks"]
    per = cfg.cross_attn_every - 1 if cfg.cross_attn_every else 1
    groups = range(0, len(blocks), per)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g, first in enumerate(groups):
        fn = functools.partial(
            _group, params, cfg, first, per, g if cfg.cross_attn_every
            else None, caches, image_embeds, extra_mask, valid)
        if remat:
            x, a = remat_wrap(cfg, fn)(x, positions)
        else:
            x, a = fn(x, positions)
        aux = aux + a
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _group(params, cfg: ModelConfig, first: int, n: int, cross: int | None,
           caches, image_embeds, extra_mask, valid, x: torch.Tensor,
           positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Self blocks ``first .. first + n − 1`` then, for a VLM, cross block
    ``cross``: -> (x, the summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(first, first + n):
        x, _c, a = apply_block(params["blocks"][i], cfg, x, positions,
                               cache=None if caches is None else caches[i],
                               extra_mask=extra_mask, valid=valid)
        aux = aux + a
    if cross is not None:
        cp = params["cross_blocks"][cross]
        hn = L.rmsnorm(cp["norm"], x, cfg.norm_eps)
        x = x + L.apply_cross_attention(cp["xattn"], cfg, hn, image_embeds)
    return x, aux


def unembed_table(params, cfg: ModelConfig) -> dict:
    """The unembedding: the embedding's table when tied."""
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def forward(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B, S) int, optional "positions" (B, S),
    "input_embeds" (B, S, D) (the audio stub's frame embeddings, used in
    place of the token embeddings), "image_embeds" (B, T_img, D),
    "extra_mask" (B, S, S) bool} -> logits (B, S, V) float32."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).repeat(b, 1)
    if batch.get("input_embeds") is not None:
        x = batch["input_embeds"].to(_dt(cfg, "compute"))
    else:
        x = L.embed(params["embed"], cfg, tokens)
    x, _aux = run_blocks(params, cfg, x, positions,
                         image_embeds=batch.get("image_embeds"),
                         extra_mask=batch.get("extra_mask"))
    return L.unembed(unembed_table(params, cfg), cfg, x)


class _TokenNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over the full
    vocabulary, with no float32 (B, S, V) copy beyond the logits: the
    forward reduces ``ROWS`` rows at a time, the backward writes
    ``softmax - onehot`` (times the cotangent) as its one full tensor."""

    ROWS = 1024

    @staticmethod
    def forward(ctx, logits, labels):
        flat = logits.reshape(-1, logits.shape[-1])
        lse = torch.cat([torch.logsumexp(flat[i:i + _TokenNLL.ROWS], -1)
                         for i in range(0, flat.shape[0], _TokenNLL.ROWS)])
        lse = lse.reshape(labels.shape)
        gold = logits.gather(-1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        grad = torch.sub(logits, lse[..., None]).exp_().mul_(g[..., None])
        grad.scatter_add_(-1, labels[..., None], -g[..., None])
        return grad, None


def _token_nll(logits: torch.Tensor, labels: torch.Tensor):
    """-> (per-token NLL, float32 argmax hits) of (B, S, V) logits."""
    nll = _TokenNLL.apply(logits, labels)
    with torch.no_grad():
        hits = (logits.argmax(-1) == labels).to(torch.float32)
    return nll, hits


def loss_fn(params, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Causal LM loss (the reference's): mean over ``loss_mask`` (ones when
    absent) of ``logsumexp(logits) - logits[label]`` -> (loss, {"loss",
    "accuracy", "tokens"}), 0-d float32 tensors; accuracy is the masked
    share of argmax hits, tokens the mask's sum.  Under a mesh the NLL and
    the hits are taken on each rank's rows of the logits, gathered over the
    vocabulary (:func:`layers.local_call`)."""
    logits = forward(params, cfg, batch)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32,
                       device=logits.device) if mask is None
            else mask.to(torch.float32))
    if isinstance(logits, DTensor):
        rows = L.batch_placements(logits.device_mesh, logits.shape[0])
        nll, hits = L.local_call(_token_nll, (logits, labels), (rows, rows),
                                 (rows, rows))
    else:
        nll, hits = _token_nll(logits, labels)
    nll = nll * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    with torch.no_grad():
        acc = (hits * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": acc,
                  "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, s_max: int,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> list[dict]:
    """Per-self-block caches: ``"kv"`` for attention and hybrid blocks (a
    sliding-window config gets ``min(s_max, window)`` slots, a ring
    buffer), ``"ssm"`` for SSM and hybrid blocks (float32 state, conv
    window in the compute type)."""
    s_eff = min(s_max, cfg.sliding_window) if cfg.sliding_window else s_max
    caches = []
    for _ in range(cfg.n_layers - n_cross_blocks(cfg)):
        c = {}
        if cfg.block_type in ("attention", "hybrid"):
            c["kv"] = L.init_kv_cache(cfg, batch, s_eff, dtype, device)
        if cfg.block_type in ("ssm", "hybrid"):
            c["ssm"] = SSM.init_ssm_cache(cfg, batch, device)
        caches.append(c)
    return caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                caches: list[dict], positions: torch.Tensor, *,
                image_embeds: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, list[dict]]:
    """One decode step: tokens (B, 1) at positions (B, 1) -> (logits (B, 1,
    V), caches), the caches updated in place; a VLM's cross blocks attend
    to ``image_embeds`` between its self blocks, as in :func:`forward`."""
    x = L.embed(params["embed"], cfg, tokens)
    x, _aux = run_blocks(params, cfg, x, positions, caches,
                         image_embeds=image_embeds)
    return L.unembed(unembed_table(params, cfg), cfg, x), caches
