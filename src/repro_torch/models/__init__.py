"""Model layers of the port (see ``repro.models`` for the reference).

quant — binary (1-bit) linear layers on the popcount GEMM kernel
"""
from .quant import (BinaryLinear, apply_binary_linear, binarize_pack,
                    binary_matmul, init_binary_linear, ste_binary_matmul)

__all__ = ["BinaryLinear", "apply_binary_linear", "binarize_pack",
           "binary_matmul", "init_binary_linear", "ste_binary_matmul"]
