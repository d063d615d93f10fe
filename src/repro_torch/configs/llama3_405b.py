"""llama3-405b [arXiv:2407.21783].

Dense GQA: 126L d_model=16384 128H (kv=8) d_ff=53248 vocab=128256.
Adafactor + bf16 params + full remat + FSDP parameter sharding: the
combination that fits 16 GB/chip HBM on the production mesh (DESIGN.md §5).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
    n_kv_heads=8, d_ff=53248, vocab=128256, rope_theta=500000.0,
    param_dtype="bfloat16", optimizer="adafactor", remat="full",
)
