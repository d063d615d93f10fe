"""``experts_swiglu_roofline``: the least time of the traced calls' SwiGLU
grouped expert launches (``bench.roofline_moe_swiglu.grouped_launch`` over
each launch's experts with rows and rows, from the engine's ``moe.launch``
records) over the device time of the SwiGLU grouped kernel
(``moe_grouped_swiglu_*``, both of its launches) in the traced window, in
%.  None where the window ran no such kernel."""
from bench import roofline_moe_swiglu, serve_spans


def read(ctx):
    recs = serve_spans.records(ctx)
    if not ctx.trace or recs is None:
        return None
    launches = [x for r in recs for x in r.get("lists", {}).get(
        "moe.launch", [])]
    t = serve_spans.device_s(ctx, "moe_grouped_swiglu")
    if not launches or t <= 0:
        return None
    d, f = ctx.config["hidden_size"], ctx.config["intermediate_size"]
    least = sum(roofline_moe_swiglu.bound_s(
        *roofline_moe_swiglu.grouped_launch(e, r, d, f)) for e, r in launches)
    return 100.0 * least / t
