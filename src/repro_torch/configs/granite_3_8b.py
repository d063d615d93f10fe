"""granite-3-8b: IBM Granite 3.0 family GQA decoder
[hf:ibm-granite/granite-3.0-2b-base, scaled per assignment].

Dense GQA: 40L d_model=4096 32H (kv=8) d_ff=12800 vocab=49155.
Note the non-power-of-two vocab (49155): the embedding shards on d_model
because 49155 % 16 != 0 (sharding rule falls back automatically).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, rope_theta=10000.0, tie_embeddings=True,
    param_dtype="bfloat16", optimizer="adamw", remat="block",
)
