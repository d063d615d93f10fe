"""``scatter_GB_per_call``: the program's ``scatter_bytes`` counter per
traced call, in GB (1e9 B): bytes written into the bank's slot buffers by
row index (staging, Frac, RowClone, write-back)."""
from bench import spans


def read(ctx):
    n = spans.per_call(ctx, "scatter_bytes")
    return None if n is None else n / 1e9
