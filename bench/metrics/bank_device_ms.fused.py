"""``bank_device_ms.fused``: ``bank_device_ms`` in a cell whose banks fuse
(``core/fused.py``), read alike: device time per call of every device
operation but the sense-amp kernel, from the traced window, in ms."""
from pathlib import Path

from bench.manifest import load_module

read = load_module(Path(__file__).with_name("bank_device_ms.py"),
                   "bank_device_ms").read
