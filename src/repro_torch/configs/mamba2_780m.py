"""mamba2-780m [arXiv:2405.21060]: SSD (state-space duality), attention-free.

SSM: 48L d_model=1536 ssm_state=128 vocab=50280; d_inner=3072 (expand 2),
48 SSD heads of dim 64.  O(1) decode state => runs the 500k cell.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, block_type="ssm", ssm_state=128, ssm_expand=2,
    ssm_head_dim=64, tie_embeddings=True,
    param_dtype="bfloat16", optimizer="adamw", remat="block",
)
