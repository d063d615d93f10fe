"""Model layers of the port (see ``repro.models`` for the reference).

config      — ``ModelConfig`` / ``ShapeConfig`` / ``SHAPES`` /
              ``TrainConfig`` (copies)
layers      — RMSNorm, RoPE, GQA attention on the flash-attention kernels
              (``fused_attention``: forward and backward), cross-attention,
              SwiGLU, embedding
moe         — the capacity-based top-k Mixture-of-Experts layer
ssm         — Mamba2 (SSD) blocks: the chunked scan and the decode step
transformer — the decoder of every family: init_params, forward, loss_fn,
              init_caches, decode_step
quant       — binary (1-bit) linear layers on the popcount GEMM kernel
"""
from .quant import (BinaryLinear, apply_binary_linear, binarize_pack,
                    binary_matmul, init_binary_linear, ste_binary_matmul)

__all__ = ["BinaryLinear", "apply_binary_linear", "binarize_pack",
           "binary_matmul", "init_binary_linear", "ste_binary_matmul"]
