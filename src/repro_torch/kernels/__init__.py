"""Hand-written Hopper kernels of the port, each beside its plain twin.

senseamp — fused charge-share + sense-amp Monte-Carlo resolve (CUDA C++)
bitwise  — N-ary AND/OR/NAND/NOR/XOR reduce, NOT and MAJ3 on packed planes
           (CUDA C++)
bitserial — ripple-carry adder and bit-sliced popcount on packed planes
           (CUDA C++)
popcount_gemm — 1-bit GEMM through AND / XNOR + popcount (CUDA C++)
flash_attention — flash-attention forward over grouped K/V (CUDA C++,
           bf16 tensor cores / float32 CUDA cores)
moe_grouped — a dropless MoE's grouped expert product (CUDA C++, wgmma)
ssd      — the Mamba-2 mixer's chunked path: conv, float32 SSD and gated
           norm in five launches (CUDA C++, float32 CUDA cores)
ops      — entry points, dispatched by tensor device
ref      — plain PyTorch oracles of the reference kernels
build    — nvcc build of ``csrc/*.cu`` into ``build/kernels``, ctypes load
"""
