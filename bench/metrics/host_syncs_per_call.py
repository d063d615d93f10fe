"""``host_syncs_per_call``: the host's reads of device data in one call
(``bench.syncs.HostReads``: scalar reads, ``nonzero``, copies to the host),
counted op by op over calls made after the traced window.  Layer: the MC
driver and ISA (``core/charz.py``, ``core/isa.py``) and the bank above the
kernels."""


def read(ctx):
    if not ctx.host_read_calls:
        return None
    return ctx.host_reads / ctx.host_read_calls
