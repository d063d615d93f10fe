"""hymba-1.5b [arXiv:2411.13676]: parallel attention + Mamba heads.

Hybrid: 32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001 ssm_state=16.
Sliding-window attention (2048) in the attention path => the 500k-token
long-context decode cell runs with O(window)+O(1) state.
25 heads do not divide the 16-way model axis: attention stays head-
replicated and shards via sequence/batch (DESIGN.md §Arch-applicability).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64, sliding_window=2048,
    block_type="hybrid", ssm_state=16, ssm_expand=1, ssm_head_dim=64,
    rope_theta=10000.0,
    param_dtype="bfloat16", optimizer="adamw", remat="block",
)
