"""``ssm_scan_kernel_share``: of each traced call's chunked Mamba-2 mixer
calls (``ssm.scan_kernel`` and ``ssm.scan_plain`` in its ``serve.run``
record), the share that launched the hand-written kernels, averaged over
the traced calls; None where the records count neither (a program without
these counters)."""
from bench import serve_spans


def read(ctx):
    recs = serve_spans.records(ctx)
    if not recs:
        return None
    shares = []
    for r in recs:
        k = r["counts"].get("ssm.scan_kernel", 0)
        n = k + r["counts"].get("ssm.scan_plain", 0)
        if n:
            shares.append(k / n)
    return sum(shares) / len(shares) if shares else None
