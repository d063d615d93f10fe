"""granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small, config.json,
``model_type`` granitemoehybrid]: 40 layers by ``layer_types`` — 36 Mamba-2
(``M``) and 4 attention (``*``, layers 5, 15, 25, 35) — each a mixer then
a MoE; d_model 4096, vocab 100352, tied embeddings; 32,207,337,984
parameters (59.99 GiB in bf16), about 9 B active a token.  Port only: the
reference package has no such model, and training and the mesh are not
wired for it.

The layer equations (``x`` the residual stream; ``rms_norm_eps`` 1e-5;
``r`` = ``residual_multiplier`` 0.22):

* the input: ``x = 12 · embed(tokens)`` (``embedding_multiplier``);
* every layer: ``x = x + r · mixer(rmsnorm₁(x))``, then ``x = x + r ·
  moe(rmsnorm₂(x))``; after the last, a final ``rmsnorm`` and the tied
  unembedding (the embedding's table), the logits divided by 16
  (``logits_scaling``);
* ``*``: q, k, v projections without bias, 32 query and 8 KV heads of 128,
  causal softmax attention of scores ``q·k · 0.0078125``
  (``attention_multiplier``, in place of ``1/√128``) with no positional
  embedding (``position_embedding_type`` ``nope``), then ``o_proj``;
* ``M``: the input projection (no bias) gives ``[z (8192), x (8192), B
  (128), C (128), dt (128)]``; a causal depthwise conv of width 4 with bias
  over ``[x, B, C]``, then SiLU; ``dt = softplus(dt + dt_bias)`` (the
  ``time_step_limit`` (0, ∞) clamps nothing), ``A = −exp(A_log)``; the SSD
  of 128 heads of 64 over one group of B and C (state 128, chunk 256),
  plus ``D`` per head; ``y = rmsnorm(y · silu(z)) · w`` over the one group
  of 8192 (gate before norm); the output projection (no bias);
* MoE: the router ``Linear(4096, 72)`` without bias in float32, the top 10
  of its logits and the softmax over those 10 (the port takes the softmax
  over all 72, then the top 10 renormalised: the same weights); each
  routed expert ``down(silu(g) · u)`` with ``[g, u]`` the chunks of
  ``input_linear`` (72, 2·768, 4096), gate rows first, and ``down`` the
  ``output_linear`` (72, 4096, 768); the shared expert the same at 1536,
  its ``input_linear`` (2·1536, 4096); the routed sum plus the shared
  output.
"""
from ..models.config import PatternConfig

#: the published ``layer_types``: attention at layers 5, 15, 25 and 35
PATTERN = "".join("*" if i % 10 == 5 else "M" for i in range(40))

CONFIG = PatternConfig(
    name="granite-4.0-h-small", n_layers=40, d_model=4096, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=1536, vocab=100352, rope=False,
    rope_theta=10000.0, layer_pattern=PATTERN, layer_ffn="moe",
    tie_embeddings=True,
    moe=True, n_experts=72, n_shared_experts=1, moe_top_k=10, d_expert=768,
    capacity_factor=0.0, mlp_act="swiglu", router="softmax",
    ssm_state=128, ssm_n_heads=128, ssm_head_dim=64, ssm_groups=1,
    ssm_conv=4, ssm_chunk=256,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, attn_scale=0.0078125,
    norm_eps=1e-5, param_dtype="bfloat16", compute_dtype="bfloat16",
)
