"""Model configuration covering all assigned architecture families, and the
training loop's ``TrainConfig`` (a copy of ``repro.models.config``).

One dataclass drives dense GQA transformers, MoE, SSM (Mamba2/SSD), hybrid
(parallel attention+SSM), audio-token decoders and cross-attention VLM
backbones.  Exact per-arch instantiations live in ``repro_torch.configs``.

A non-empty ``layer_pattern`` (the port's own, a field of
:class:`PatternConfig`; the reference has none) gives
each layer one of three mixer kinds, one character a layer: ``M`` a
Mamba-2 mixer, ``E`` a MoE, ``*`` attention; ``block_type`` is then unused.
With ``layer_ffn`` empty (Nemotron-H) such a layer computes ``x +
mixer(rmsnorm(x))`` and has no second sub-layer; with ``layer_ffn="moe"``
(Granite 4.0-H) every layer, ``M`` or ``*``, is a mixer then a MoE: ``x +=
r · mixer(rmsnorm₁(x))``, then ``x += r · moe(rmsnorm₂(x))``, ``r`` the
``residual_multiplier``.  Granite's other scalars: ``embedding_multiplier``
(the embeddings' factor), ``logits_scaling`` (the logits' divisor) and
``attn_scale`` (the attention's score scale; 0 for ``1/√hd``).  The MoE
options a pattern brings: ``mlp_act="relu2"`` experts
(``down(relu(up(h))²)``, no gate projection), ``router="sigmoid"``, which
always has a score-correction bias (it picks the top k, the weights are
the plain scores), ``routed_scaling``, and the dropless dispatch
(``capacity_factor = 0``).  The SSM options: an explicit head count
(``ssm_n_heads``; ``d_inner = ssm_n_heads · ssm_head_dim``), ``ssm_groups``
groups of B and C (head ``h`` reads group ``h // (heads / groups)``) and a
gated RMSNorm over each of ``ssm_groups`` slices of ``d_inner``.
``rope=False`` leaves the attention without positional embedding.
:func:`option` reads one of :class:`PatternConfig`'s own fields from any
config: its value, or the field's default for a plain :class:`ModelConfig`
(the fields that came before it are also class attributes of
:class:`ModelConfig`, read directly).
``fused_attention`` has no effect in the port (every attention without
``extra_mask`` runs the flash-attention kernels, forward and backward).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


#: the layer kinds of ``layer_pattern``, by character (Nemotron-H's
#: ``hybrid_override_pattern``)
LAYER_KINDS = {"M": "ssm", "E": "moe", "*": "attention"}


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
    capacity_factor: float = 1.25    # 0 = dropless (no capacity)
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

    # --- the port's own options (fields of :class:`PatternConfig`; class
    # attributes here, so that a ModelConfig's fields stay the reference's)
    layer_pattern = ""               # "" | one of M, E, * a layer
    rope = True                      # False: no positional embedding
    mlp_act = "swiglu"               # swiglu | relu2 (experts, shared too)
    router = "softmax"               # softmax | sigmoid
    routed_scaling = 1.0             # the routed sum's factor
    ssm_n_heads = 0                  # 0 -> expand * d_model / head_dim
    ssm_groups = 1                   # groups of B and C (and of the norm)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        if self.layer_pattern:
            return "*" not in self.layer_pattern
        return self.block_type == "ssm"

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Each layer's kind: ``"attention"``, ``"ssm"`` or ``"moe"`` for a
        pattern model; every layer ``block_type`` otherwise."""
        if not self.layer_pattern:
            return (self.block_type,) * self.n_layers
        return tuple(LAYER_KINDS[c] for c in self.layer_pattern)

    @property
    def has_ssm(self) -> bool:
        """Some layer holds an SSM state (prompts pad to ``ssm_chunk``)."""
        return any(k in ("ssm", "hybrid") for k in self.layer_kinds)

    @property
    def n_attention_layers(self) -> int:
        """Layers that attend over a KV cache (cross blocks not counted)."""
        return sum(k in ("attention", "hybrid") for k in self.layer_kinds)

    @property
    def d_inner(self) -> int:
        if self.ssm_n_heads:
            return self.ssm_n_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode state (SSM/hybrid/sliding-window archs)."""
        return self.block_type in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def n_moe_layers(self) -> int:
        """Layers that hold a MoE (a pattern model's ``E`` layers, or every
        layer under ``layer_ffn="moe"``)."""
        if not self.layer_pattern:
            return self.n_layers if self.moe else 0
        if option(self, "layer_ffn") == "moe":
            return self.n_layers
        return self.layer_kinds.count("moe")

    def __post_init__(self):
        if self.layer_pattern:
            bad = set(self.layer_pattern) - set(LAYER_KINDS)
            if bad or len(self.layer_pattern) != self.n_layers:
                raise ValueError(
                    f"{self.name}: layer_pattern {self.layer_pattern!r} "
                    f"wants {self.n_layers} of {sorted(LAYER_KINDS)}")
            ffn = option(self, "layer_ffn")
            if ffn not in ("", "moe") or (ffn and "E" in self.layer_pattern):
                raise ValueError(f"{self.name}: layer_ffn {ffn!r} wants '' "
                                 f"or 'moe' on a pattern without E layers")

    def _pattern_param_count(self) -> int:
        """Exact count of a pattern model: per layer its pre-norm and its
        mixer — attention q, k, v, o; Mamba-2 in / out projections, the
        conv with its bias, ``A_log``, ``D``, ``dt_bias`` and the grouped
        norm's scale; MoE router and its bias, the routed and shared
        experts (two matrices each under relu², three under SwiGLU); under
        ``layer_ffn="moe"`` every layer adds a second norm and a MoE."""
        d, hd = self.d_model, self.hd
        mats = 2 if self.mlp_act == "relu2" else 3
        di, nh = self.d_inner, self.ssm_heads
        gs = 2 * self.ssm_groups * self.ssm_state
        per = {
            "attention": 2 * d * self.n_heads * hd
            + 2 * d * self.n_kv_heads * hd,
            "ssm": d * (2 * di + gs + nh) + di * d
            + (self.ssm_conv + 1) * (di + gs) + 3 * nh + di,
            "moe": d * self.n_experts
            + self.n_experts * (self.router == "sigmoid")
            + mats * d * self.d_expert * self.n_experts
            + mats * d * self.d_ff * self.n_shared_experts,
        }
        ffn = per["moe"] + d if option(self, "layer_ffn") == "moe" else 0
        n = self.vocab * d * (1 if self.tie_embeddings else 2) + d
        return n + sum(per[k] + d + ffn for k in self.layer_kinds)

    def param_count(self) -> int:
        """Approximate parameter count (documented formula, used for
        MODEL_FLOPS in the roofline); exact for a pattern model."""
        if self.layer_pattern:
            return self._pattern_param_count()
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
        mats = 2 if self.mlp_act == "relu2" else 3
        inactive = (self.n_experts - self.moe_top_k) * mats * self.d_model \
            * self.d_expert * (self.n_moe_layers if self.layer_pattern
                               else self.n_layers)
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
        if self.has_ssm:
            kw.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=16)
        if self.ssm_n_heads:
            kw.update(ssm_n_heads=4, ssm_groups=min(self.ssm_groups, 2))
        if self.layer_pattern:
            # one layer of each kind the pattern has, in the order met
            kinds = "".join(dict.fromkeys(self.layer_pattern))
            kw.update(layer_pattern=kinds, n_layers=len(kinds))
        if self.cross_attn_every:
            kw.update(cross_attn_every=2, n_image_tokens=8)
        if self.sliding_window:
            kw.update(sliding_window=16)
        return self.replace(**kw)


@dataclass(frozen=True)
class PatternConfig(ModelConfig):
    """A :class:`ModelConfig` with the port's own options as fields: the
    per-layer pattern of mixers, each layer's second sub-layer, and what
    its layers take (see the module's docstring).  Nemotron-H and Granite
    4.0-H are two."""

    layer_pattern: str = ""
    rope: bool = True
    mlp_act: str = "swiglu"
    router: str = "softmax"
    routed_scaling: float = 1.0
    ssm_n_heads: int = 0
    ssm_groups: int = 1
    layer_ffn: str = ""              # "" | "moe": every layer's second part
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attn_scale: float = 0.0          # 0 -> 1 / sqrt(hd)


#: :class:`PatternConfig`'s own fields and their defaults
_OWN = {f.name: f.default for f in dataclasses.fields(PatternConfig)
        if f.name not in {g.name for g in dataclasses.fields(ModelConfig)}}


def option(cfg: ModelConfig, name: str):
    """``cfg``'s value of one of :class:`PatternConfig`'s own fields, or the
    field's default where ``cfg`` is a plain :class:`ModelConfig`."""
    return getattr(cfg, name, _OWN[name])


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
