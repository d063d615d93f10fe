"""``call_ms_p95``: the 95th percentile of every timed call's wall, in ms
(host clock; each call ends in its own host reads and a synchronize)."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.walls, 95)) * 1e3 if ctx.walls else None
