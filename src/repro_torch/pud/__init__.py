"""Framework-side PuD engine of the port: backend dispatch, masks, Bloom
dedup, compiled workloads (bloom insert/probe, bit-serial dot products)."""
from .engine import OffloadReport, PudEngine
from .workloads import (bloom_insert_program, bloom_probe_program,
                        dot_bitserial, dot_program)

__all__ = ["OffloadReport", "PudEngine", "bloom_insert_program",
           "bloom_probe_program", "dot_bitserial", "dot_program"]
