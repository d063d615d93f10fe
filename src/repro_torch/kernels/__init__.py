"""Hand-written Hopper kernels of the port, each beside its plain twin.

senseamp — fused charge-share + sense-amp Monte-Carlo resolve (CUDA C++)
ops      — entry points, dispatched by tensor device
ref      — plain PyTorch oracles of the reference kernels
build    — nvcc build of ``csrc/*.cu`` into ``build/kernels``, ctypes load
"""
