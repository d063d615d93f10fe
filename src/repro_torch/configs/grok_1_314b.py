"""grok-1-314b [hf:xai-org/grok-1].

MoE: 64L d_model=6144 48H (kv=8) d_ff=32768 vocab=131072; 8 experts top-2;
attention logit softcap 30 (grok's tanh capping).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, rope_theta=10000.0, attn_logit_softcap=30.0,
    moe=True, n_experts=8, n_shared_experts=0, moe_top_k=2, d_expert=32768,
    param_dtype="bfloat16", optimizer="adafactor", remat="full",
)
