"""``device_idle_share``: the share of the traced window in which no device
operation ran (the union of the trace's device intervals)."""


def read(ctx):
    if not ctx.trace or ctx.window_trace_s <= 0:
        return None
    return 1.0 - ctx.busy_s / ctx.window_trace_s
