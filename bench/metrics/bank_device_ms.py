"""``bank_device_ms``: device time per call of every device operation but
the sense-amp kernel, from the traced window, in ms: the bank's staging,
draws, op-context sums and write-back (``core/simulator.py``,
``core/fused.py``, ``core/bankarray.py``)."""


def read(ctx):
    tr = ctx.trace
    if not tr or not tr["device"] or not ctx.traced_calls:
        return None
    s = sum(e - b for name, b, e in tr["device"] if "senseamp" not in name)
    return s / ctx.traced_calls * 1e3
