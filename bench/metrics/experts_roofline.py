"""``experts_roofline``: the least time of the traced calls' grouped expert
launches (``bench.roofline_moe.grouped_launch`` over each launch's experts
with rows and rows, from the engine's records) over the device time of the
grouped kernels (``moe_grouped_*``) in the traced window, in %."""
from bench import roofline_moe, serve_spans


def read(ctx):
    recs = serve_spans.records(ctx)
    if not ctx.trace or recs is None:
        return None
    launches = [x for r in recs for x in r.get("lists", {}).get(
        "moe.launch", [])]
    t = serve_spans.device_s(ctx, "moe_grouped")
    if not launches or t <= 0:
        return None
    d, f = ctx.config["hidden_size"], ctx.config["moe_intermediate_size"]
    least = sum(roofline_moe.bound_s(*roofline_moe.grouped_launch(e, r, d, f))
                for e, r in launches)
    return 100.0 * least / t
