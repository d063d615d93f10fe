"""``host_call_ms``: ``call_ms`` as a per-layer reading, where a cell's
calls are too few and too host-bound for a bound on it: the untraced
stretch's seconds over the MC calls it completed, in ms."""


def read(ctx):
    return ctx.window_s / ctx.n_calls * 1e3 if ctx.n_calls else None
