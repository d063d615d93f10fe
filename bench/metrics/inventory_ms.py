"""``inventory_ms``: host ms per traced call inside the program's
``pud.inventory`` spans: the pair inventory built for each new chip
identity (``core/isa.py`` ``PairInventory``)."""
from bench import spans


def read(ctx):
    return spans.span_ms(ctx, "pud.inventory")
