"""``senseamp_launches_per_call``: ``repro_torch.kernels.senseamp.launches``
counted over the traced window, per call."""


def read(ctx):
    n = ctx.launches.get("senseamp")
    if n is None or not ctx.traced_calls:
        return None
    return n / ctx.traced_calls
