"""Config-driven decoder of the port: the serving half of
``repro.models.transformer`` for ``block_type="attention"`` without MoE or
cross-attention (others raise ``NotImplementedError``, ROADMAP A-8).

Parameters are plain dicts as in the reference, with the blocks as a
Python list (one dict per layer) where the reference stacks them on a
leading layer axis for ``lax.scan``; the scan becomes a loop over layers.
Caches are a list of per-layer ``{"kv": {"k", "v", "pos"}}`` dicts,
updated in place by :func:`decode_step` (and by a prefill into them).

Entry points:
  init_params(gen, cfg)                  -> parameter dict
  forward(params, cfg, batch)            -> logits (prefill, no cache)
  decode_step(params, cfg, tokens, caches, positions) -> (logits, caches)
  init_caches(cfg, batch, s_max)         -> per-layer caches
"""
from __future__ import annotations

import torch

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
            f"ROADMAP A-8")


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


def run_blocks(params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, caches: list[dict] | None = None
               ) -> torch.Tensor:
    """Every block (the reference's scan), then the final norm."""
    for i, layer_p in enumerate(params["blocks"]):
        x, _c = apply_block(layer_p, cfg, x, positions,
                            cache=None if caches is None else caches[i])
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def unembed_table(params, cfg: ModelConfig) -> dict:
    """The unembedding: the embedding's table when tied."""
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def forward(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B, S) int, optional "positions" (B, S)} ->
    logits (B, S, V) float32.  ``input_embeds``, ``image_embeds`` and
    ``extra_mask`` raise (ROADMAP A-8)."""
    check_supported(cfg)
    for key in ("input_embeds", "image_embeds", "extra_mask"):
        if batch.get(key) is not None:
            raise NotImplementedError(f"{key} is not ported yet "
                                      f"(ROADMAP A-8)")
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).repeat(b, 1)
    x = L.embed(params["embed"], cfg, tokens)
    x = run_blocks(params, cfg, x, positions)
    return L.unembed(unembed_table(params, cfg), cfg, x)


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
