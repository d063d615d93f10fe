"""musicgen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens.

Audio backbone: 48L d_model=1536 24H (kv=24 = MHA) d_ff=6144 vocab=2048.
The EnCodec frontend is a STUB: input_specs provide precomputed frame
embeddings; the transformer operates on codec-token streams.
24 heads do not divide the 16-way model axis: attention stays head-
replicated (DESIGN.md §Arch-applicability).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_ff=6144, vocab=2048, rope_theta=10000.0,
    audio_frontend_stub=True,
    param_dtype="bfloat16", optimizer="adamw", remat="block",
)
