"""Config-driven decoder of the port: ``repro.models.transformer`` for
``block_type="attention"`` without MoE or cross-attention (others raise
``NotImplementedError``, ROADMAP A-6), serving and training.

Parameters are plain dicts as in the reference, with the blocks as a
Python list (one dict per layer) where the reference stacks them on a
leading layer axis for ``lax.scan``; the scan becomes a loop over layers.
Caches are a list of per-layer ``{"kv": {"k", "v", "pos"}}`` dicts,
updated in place by :func:`decode_step` (and by a prefill into them).

Without a cache, each block runs under the reference's remat policy
(:func:`remat_wrap`, ``cfg.remat``) when autograd records: ``"block"`` /
``"full"`` recompute the whole block in the backward
(``torch.utils.checkpoint``), ``"block_dots"`` saves the matrix products'
outputs and recomputes the rest; serving (a cache) takes no wrapper.

Entry points:
  init_params(gen, cfg)                  -> parameter dict
  forward(params, cfg, batch)            -> logits (prefill, no cache)
  loss_fn(params, cfg, batch)            -> (loss, metrics)
  decode_step(params, cfg, tokens, caches, positions) -> (logits, caches)
  init_caches(cfg, batch, s_max)         -> per-layer caches
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from . import layers as L
from .config import ModelConfig
from .layers import _dt


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the architectures the port does not serve yet."""
    if cfg.block_type != "attention" or cfg.moe or cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: only attention blocks without MoE or "
            f"cross-attention are ported (block_type={cfg.block_type!r}, "
            f"moe={cfg.moe}, cross_attn_every={cfg.cross_attn_every}); "
            f"ROADMAP A-6")


# ---------------------------------------------------------------------------
# Block = norm -> attention -> norm -> SwiGLU
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = _dt(cfg, "param")
    p: dict = {"norm1": L.init_rmsnorm(cfg.d_model, dt, gen.device),
               "attn": L.init_attention(gen, cfg)}
    if cfg.d_ff:
        p["norm2"] = L.init_rmsnorm(cfg.d_model, dt, gen.device)
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def apply_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, cache: dict | None = None,
                extra_mask: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, dict | None]:
    """-> (x_out, cache), the cache updated in place.  The reference also
    returns an auxiliary loss, which only its MoE blocks make (0 here)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    a, kvc = L.apply_attention(p["attn"], cfg, h, positions,
                               kv_cache=None if cache is None
                               else cache["kv"], extra_mask=extra_mask)
    x = x + a
    if cfg.d_ff:
        h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.apply_mlp(p["mlp"], cfg, h2)
    return x, None if cache is None else {"kv": kvc}


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device, with the reference's
    distributions: dense N(0, 1/in), embedding N(0, 0.02²), norms ones.
    Drawn layer by layer, then the embedding(s): not the reference's
    numbers (jax keys are not a torch generator)."""
    check_supported(cfg)
    p = {"blocks": [init_block(gen, cfg) for _ in range(cfg.n_layers)],
         "embed": L.init_embedding(gen, cfg),
         "final_norm": L.init_rmsnorm(cfg.d_model, _dt(cfg, "param"),
                                      gen.device)}
    if not cfg.tie_embeddings:
        p["unembed"] = {"table": L.init_embedding(gen, cfg)["table"]}
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
               positions: torch.Tensor, caches: list[dict] | None = None
               ) -> torch.Tensor:
    """Every block (the reference's scan), then the final norm.  Without
    caches and with autograd recording, each block runs under
    :func:`remat_wrap`."""
    remat = caches is None and torch.is_grad_enabled()
    for i, layer_p in enumerate(params["blocks"]):
        if remat:
            x = remat_wrap(cfg, functools.partial(_block_x, layer_p, cfg))(
                x, positions)
        else:
            x, _c = apply_block(layer_p, cfg, x, positions,
                                cache=None if caches is None else caches[i])
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _block_x(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    return apply_block(p, cfg, x, positions)[0]


def unembed_table(params, cfg: ModelConfig) -> dict:
    """The unembedding: the embedding's table when tied."""
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def forward(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B, S) int, optional "positions" (B, S)} ->
    logits (B, S, V) float32.  ``input_embeds``, ``image_embeds`` and
    ``extra_mask`` raise (ROADMAP A-6)."""
    check_supported(cfg)
    for key in ("input_embeds", "image_embeds", "extra_mask"):
        if batch.get(key) is not None:
            raise NotImplementedError(f"{key} is not ported yet "
                                      f"(ROADMAP A-6)")
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).repeat(b, 1)
    x = L.embed(params["embed"], cfg, tokens)
    x = run_blocks(params, cfg, x, positions)
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


def loss_fn(params, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Causal LM loss (the reference's): mean over ``loss_mask`` (ones when
    absent) of ``logsumexp(logits) - logits[label]`` -> (loss, {"loss",
    "accuracy", "tokens"}), 0-d float32 tensors; accuracy is the masked
    share of argmax hits, tokens the mask's sum."""
    logits = forward(params, cfg, batch)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32,
                       device=logits.device) if mask is None
            else mask.to(torch.float32))
    nll = _TokenNLL.apply(logits, labels) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    with torch.no_grad():
        hits = (logits.argmax(-1) == labels).to(torch.float32)
        acc = (hits * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": acc,
                  "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, s_max: int,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> list[dict]:
    """Per-layer caches; a sliding-window config gets ``min(s_max,
    window)`` slots (a ring buffer)."""
    check_supported(cfg)
    s_eff = min(s_max, cfg.sliding_window) if cfg.sliding_window else s_max
    return [{"kv": L.init_kv_cache(cfg, batch, s_eff, dtype, device)}
            for _ in range(cfg.n_layers)]


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                caches: list[dict], positions: torch.Tensor,
                ) -> tuple[torch.Tensor, list[dict]]:
    """One decode step: tokens (B, 1) at positions (B, 1) -> (logits (B, 1,
    V), caches), the caches updated in place."""
    x = L.embed(params["embed"], cfg, tokens)
    x = run_blocks(params, cfg, x, positions, caches)
    return L.unembed(unembed_table(params, cfg), cfg, x), caches
