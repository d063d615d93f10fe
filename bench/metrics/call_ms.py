"""``call_ms``: the window's seconds over the MC calls it completed, in ms:
the time to one success rate at the mix's size."""


def read(ctx):
    return ctx.window_s / ctx.n_calls * 1e3 if ctx.n_calls else None
