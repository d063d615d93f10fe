"""``program_reads_per_call``: the program's ``reads.opctx`` plus
``reads.score`` counters per traced call: the host reads of device data
counted at their sites (the op-context level, the score), beside
``host_syncs_per_call``, which counts them op by op from outside."""
from bench import spans


def read(ctx):
    return spans.per_call(ctx, "reads.opctx", "reads.score")
