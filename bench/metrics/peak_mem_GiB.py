"""``peak_mem_GiB``: ``torch.cuda.max_memory_allocated()`` over the run,
set-up included, read as the window closes, in GiB."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30 if ctx.memory_peak_bytes else None
