"""Hand-written Hopper kernels of the port, each beside its plain twin.

senseamp — fused charge-share + sense-amp Monte-Carlo resolve (CUDA C++)
bitwise  — N-ary AND/OR/NAND/NOR/XOR reduce, NOT and MAJ3 on packed planes
           (CUDA C++)
bitserial — ripple-carry adder and bit-sliced popcount on packed planes
           (CUDA C++)
popcount_gemm — 1-bit GEMM through AND / XNOR + popcount (CUDA C++)
ops      — entry points, dispatched by tensor device
ref      — plain PyTorch oracles of the reference kernels
build    — nvcc build of ``csrc/*.cu`` into ``build/kernels``, ctypes load
"""
