"""minitron-8b: width/depth-pruned Nemotron-4 [arXiv:2407.14679].

Dense GQA: 32L d_model=4096 32H (kv=8) d_ff=16384 vocab=256000.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000, rope_theta=500000.0,
    param_dtype="bfloat16", optimizer="adamw", remat="block",
)
