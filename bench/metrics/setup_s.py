"""``setup_s``: process start to the first timed call: imports, the CUDA
context, the kernels' load (their build on a checkout's first run) and the
warm-up calls of the cell's own shape."""


def read(ctx):
    return ctx.setup_s
