"""``senseamp_roofline``: the least time of one call's sense-amp resolves
(``bench.roofline.senseamp_apa`` over the shapes the driver derives from
the mix) over the sense-amp kernel's device time per call in the traced
window, in %.  Bound by bytes at these shapes."""
from bench import roofline


def read(ctx):
    tr = ctx.trace
    if not tr or not ctx.apas or not ctx.traced_calls:
        return None
    t = sum(e - b for name, b, e in tr["device"] if "senseamp" in name)
    if t <= 0:
        return None
    least = sum(roofline.bound_s(*roofline.senseamp_apa(**a))
                for a in ctx.apas)
    return 100.0 * least / (t / ctx.traced_calls)
