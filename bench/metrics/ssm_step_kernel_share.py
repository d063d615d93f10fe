"""``ssm_step_kernel_share``: of each traced call's recurrent Mamba-2 steps
(``ssm.step_kernel`` and ``ssm.step_plain`` in its ``serve.run`` record,
which the engine adds each decode step from what the decode graph counted
at its capture), the share that ran the hand-written step kernels, averaged
over the traced calls; None where the records count neither (a program
without these counters)."""
from bench import serve_spans


def read(ctx):
    recs = serve_spans.records(ctx)
    if not recs:
        return None
    shares = []
    for r in recs:
        k = r["counts"].get("ssm.step_kernel", 0)
        n = k + r["counts"].get("ssm.step_plain", 0)
        if n:
            shares.append(k / n)
    return sum(shares) / len(shares) if shares else None
