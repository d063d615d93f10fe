"""Model configuration covering all assigned architecture families, and the
training loop's ``TrainConfig`` (a copy of ``repro.models.config``).

One dataclass drives dense GQA transformers, MoE, SSM (Mamba2/SSD), hybrid
(parallel attention+SSM), audio-token decoders and cross-attention VLM
backbones.  Exact per-arch instantiations live in ``repro_torch.configs``.
``fused_attention`` has no effect in the port (every attention without
``extra_mask`` runs the flash-attention kernels, forward and backward).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int            # query heads; 0 for attention-free archs
    n_kv_heads: int
    d_ff: int               # dense FFN hidden size (0 = no MLP, e.g. mamba2)
    vocab: int
    head_dim: int = 0       # 0 -> d_model // n_heads
    # --- attention options ---
    qk_norm: bool = False
    rope_theta: float = 500000.0
    sliding_window: int = 0          # 0 = full attention
    attn_logit_softcap: float = 0.0
    # --- block structure ---
    block_type: str = "attention"    # attention | ssm | hybrid
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0                # routed expert hidden size
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- VLM cross-attention ---
    cross_attn_every: int = 0        # every k-th layer is a cross-attn block
    n_image_tokens: int = 0          # stub frontend: precomputed embeddings
    # --- audio stub ---
    audio_frontend_stub: bool = False
    # --- numerics / training ---
    param_dtype: str = "float32"     # float32 | bfloat16
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"         # adamw | adafactor
    remat: str = "block"             # none | block | full
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # --- performance options (§Perf hillclimb) ---
    fused_attention: bool = False    # route through the Pallas flash region
    # --- PuD engine integration ---
    pud_masks: bool = True           # compose attention masks as bit-planes
    quant_proj: str = "none"         # none | binary (XNOR popcount linears)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.block_type == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode state (SSM/hybrid/sliding-window archs)."""
        return self.block_type in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Approximate parameter count (documented formula, used for
        MODEL_FLOPS in the roofline)."""
        d, l, v = self.d_model, self.n_layers, self.vocab
        hd = self.hd
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.block_type in ("attention", "hybrid"):
            q = self.n_heads * hd
            kv = self.n_kv_heads * hd
            per_layer += d * q + 2 * d * kv + q * d       # qkv + out
        if self.block_type in ("ssm", "hybrid"):
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * di + 2 * ds + nh) + di * d
            per_layer += self.ssm_conv * (di + 2 * ds) + 2 * nh
        if self.moe:
            per_layer += 3 * d * self.d_expert * self.n_experts
            per_layer += 3 * d * self.d_ff * self.n_shared_experts
            per_layer += d * self.n_experts                # router
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff                 # SwiGLU
        per_layer += 2 * d                                 # norms
        if self.cross_attn_every:
            n_cross = l // self.cross_attn_every
            q = self.n_heads * hd
            kv = self.n_kv_heads * hd
            n += n_cross * (d * q + 2 * d * kv + q * d + 2 * d)
        return n + l * per_layer + d

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        inactive = (self.n_experts - self.moe_top_k) * 3 * self.d_model \
            * self.d_expert * self.n_layers
        return full - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=2, d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=256, head_dim=16 if self.n_heads else 0,
            param_dtype="float32", compute_dtype="float32",
        )
        if self.moe:
            kw.update(n_experts=4, n_shared_experts=min(self.n_shared_experts, 1),
                      moe_top_k=min(self.moe_top_k, 2), d_expert=32)
        if self.block_type in ("ssm", "hybrid"):
            kw.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=16)
        if self.cross_attn_every:
            kw.update(cross_attn_every=2, n_image_tokens=8)
        if self.sliding_window:
            kw.update(sliding_window=16)
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration (per run)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    n_microbatches: int = 1
    grad_compression: str = "none"   # none | int8_ef (error feedback)
    seed: int = 0
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
