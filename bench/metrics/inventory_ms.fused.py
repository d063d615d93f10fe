"""``inventory_ms.fused``: ``inventory_ms`` in a cell whose banks fuse
(``core/fused.py``), read alike: host ms per traced call inside
``pud.inventory``, one inventory per bank."""
from pathlib import Path

from bench.manifest import load_module

read = load_module(Path(__file__).with_name("inventory_ms.py"),
                   "inventory_ms").read
