"""``decode_step_ms``: the host ms of one ``serve.decode`` span (one decode
step of the engine: the graph replay and its host read of the greedy
tokens), the mean over the traced window's steps."""
from bench import serve_spans


def read(ctx):
    steps = serve_spans.spans(ctx, "serve.decode")
    if not steps:
        return None
    return sum(e - s for s, e in steps) / len(steps) * 1e3
