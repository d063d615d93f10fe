"""``prefill_ms_per_ktok``: host ms inside ``serve.prefill`` spans (the
eager prefills and their first samples) per 1,000 prompt tokens the traced
calls admitted (``serve.prompt_tokens``)."""
from bench import serve_spans


def read(ctx):
    spans = serve_spans.spans(ctx, "serve.prefill")
    recs = serve_spans.records(ctx)
    if not spans or recs is None:
        return None
    tokens = sum(r["counts"].get("serve.prompt_tokens", 0) for r in recs)
    if not tokens:
        return None
    return sum(e - s for s, e in spans) * 1e3 / (tokens / 1e3)
