"""qwen3-4b: Qwen3 family with QK-norm GQA [hf:Qwen/Qwen3-8B family].

Dense GQA: 36L d_model=2560 32H (kv=8, qk_norm) d_ff=9728 vocab=151936.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1000000.0,
    param_dtype="bfloat16", optimizer="adamw", remat="block",
)
