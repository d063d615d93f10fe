"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision family].

VLM backbone: 100L d_model=8192 64H (kv=8) d_ff=28672 vocab=128256; every
5th layer is a cross-attention block over precomputed image-patch
embeddings (the vision tower is a STUB per the assignment: input_specs
provide (B, 1024, d_model) patch embeddings).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", n_layers=100, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=28672, vocab=128256, rope_theta=500000.0,
    cross_attn_every=5, n_image_tokens=1024,
    param_dtype="bfloat16", optimizer="adafactor", remat="full",
)
