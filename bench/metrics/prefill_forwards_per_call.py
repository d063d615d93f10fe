"""``prefill_forwards_per_call``: the engine's prefill forwards
(``serve.prefill_forwards``, one a batched forward of one or more
admitted requests) per traced call, from the ``serve.run`` records; None
where the records lack the counter."""
from bench import serve_spans


def read(ctx):
    recs = serve_spans.records(ctx)
    if not recs or any("serve.prefill_forwards" not in r["counts"]
                       for r in recs):
        return None
    return sum(r["counts"]["serve.prefill_forwards"] for r in recs) \
        / len(recs)
