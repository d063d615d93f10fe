"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B].

MoE: 24L d_model=2048 16H (kv=16) vocab=151936; 60 routed experts top-4
(d_expert=1408) + 4 shared experts (4*1408 = 5632 shared hidden).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=151936, rope_theta=1000000.0,
    moe=True, n_experts=60, n_shared_experts=4, moe_top_k=4, d_expert=1408,
    param_dtype="bfloat16", optimizer="adamw", remat="block",
)
