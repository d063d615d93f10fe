"""``h2d_copies_per_call``: the program's ``h2d_copies`` counter per traced
call: host arrays copied to the device (slot indices, column maps, static
offsets, host draws)."""
from bench import spans


def read(ctx):
    return spans.per_call(ctx, "h2d_copies")
