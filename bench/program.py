"""What the benchmark reads from the program under test, and nothing else.

The program is the PyTorch and CUDA port, ``repro_torch``: the drivers call
its entry points, and this module reads its kernels' launch counters and
the result rows its Monte-Carlo entry points score, so that the harness can
judge them against the reference.  Nothing here changes what the program
computes.
"""
from __future__ import annotations

import sys
from contextlib import contextmanager


def launch_counts() -> dict:
    """Every ``launches`` counter of the port's kernel modules loaded so far
    (``repro_torch.kernels.<name>.launches``), by kernel module name."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch.kernels.") and isinstance(
                getattr(mod, "launches", None), int):
            out[name.rsplit(".", 1)[1]] = mod.launches
    return out


@contextmanager
def result_rows():
    """Collect, in order, a copy of every result row block the MC scores
    (one per group, or per fused round), through the entry points' own
    hook, ``charz.collect_rows()``."""
    from repro_torch.core import charz
    with charz.collect_rows() as rows:
        yield rows
