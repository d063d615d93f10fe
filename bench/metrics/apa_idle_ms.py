"""``apa_idle_ms``: device-idle ms per traced call while one of the
program's ``pud.apa`` spans is open: the host work of the APA path (pair
choice, slot maps, staging, the op-context read, readout) that the device
waits on (``core/isa.py``, ``core/simulator.py``, ``core/fused.py``)."""
from bench import spans


def read(ctx):
    return spans.idle_ms(ctx, "pud.apa")
