"""nemotron-3-nano-30b-a3b [hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16,
config.json, ``model_type`` nemotron_h]: 52 single-mixer layers by
``hybrid_override_pattern`` — 23 Mamba-2 (``M``), 23 MoE (``E``), 6
attention (``*``) — d_model 2688, vocab 131072, untied embeddings;
31,577,940,288 parameters (58.8 GiB in bf16), about 3.2 B active a token
besides the embedding.  Port only: the reference package has no such
model, and training and the mesh are not wired for it.

The layer equations (``x`` the residual stream; ``norm_eps`` 1e-5):

* every layer: ``x = x + mixer(rmsnorm(x))``; after the last, a final
  ``rmsnorm`` and the untied ``lm_head``;
* ``*``: q, k, v projections without bias, 32 query and 2 KV heads of 128,
  causal softmax attention with no positional embedding (the published
  ``NemotronHAttention`` applies no rotary embedding; ``rope_theta`` is
  unused), then ``o_proj``;
* ``M``: the input projection (no bias) gives ``[z (4096), x (4096), B
  (8·128), C (8·128), dt (64)]``; a causal depthwise conv of width 4 with
  bias over ``[x, B, C]``, then SiLU; ``dt = softplus(dt + dt_bias)``, ``A
  = −exp(A_log)``; the SSD with head ``h`` reading group ``h // 8`` of B and
  C, plus ``D`` per head; ``y = rmsnorm_g(y · silu(z)) · w`` over groups of
  512 (gate before norm); the output projection (no bias);
* ``E``: ``s = sigmoid(x·Wr)`` in float32; the top 6 by ``s + b`` (``b``
  the score-correction bias; ``n_group`` 1, so group selection is the
  identity); weights ``s`` at the chosen experts over their sum plus
  1e-20, times 2.5; each expert ``down(relu(up(h))²)`` of width 1856, the
  shared expert the same at 3712; the routed sum plus the shared output.
"""
from ..models.config import PatternConfig

#: the published ``hybrid_override_pattern``
PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = PatternConfig(
    name="nemotron-3-nano-30b-a3b", n_layers=52, d_model=2688, n_heads=32,
    n_kv_heads=2, head_dim=128, d_ff=3712, vocab=131072, rope=False,
    rope_theta=10000.0, layer_pattern=PATTERN,
    moe=True, n_experts=128, n_shared_experts=1, moe_top_k=6, d_expert=1856,
    capacity_factor=0.0, mlp_act="relu2", router="sigmoid",
    routed_scaling=2.5,
    ssm_state=128, ssm_n_heads=64, ssm_head_dim=64, ssm_groups=8,
    ssm_conv=4, ssm_chunk=128,
    norm_eps=1e-5, param_dtype="bfloat16", compute_dtype="bfloat16",
)
