"""Bloom-filter dedup on PuD bulk ops (data-pipeline integration).

The port of ``repro.pud.bloom``.  Membership bits live in a packed
bit-plane on the engine's device; inserts are bulk ORs and probes bulk
ANDs, both as compiled programs through ``PudEngine.run_program`` (see
:mod:`repro_torch.pud.workloads`): insert is one many-input OR over the
per-hash key planes (fan-in ``n_hashes + 1``), probe one many-input AND
over the gathered membership bits (fan-in ``n_hashes``) — one
``nary_bitwise`` launch each on the ``kernel`` backend.

Key hashing stays numpy on the host (:func:`_hash_positions`, a copy of
the reference's): it relies on uint64 wrap-around and ``%`` of an unsigned
value, which PyTorch's int64 arithmetic does not give.  The positions then
move to the device, where the hash planes are scattered and the membership
bits gathered.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kops
from .engine import PudEngine
from .workloads import (bloom_insert_program, bloom_probe_program,
                        pack_lanes, unpack_lanes)


def _hash_positions(keys: np.ndarray, n_hashes: int, m_bits: int,
                    seed: int = 0) -> np.ndarray:
    """keys: (N,) uint64 -> (N, n_hashes) positions in [0, m_bits)."""
    out = np.empty((len(keys), n_hashes), dtype=np.int64)
    x = keys.astype(np.uint64)
    for h in range(n_hashes):
        mix = (seed * 2654435761 + h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        v = x * np.uint64(0x9E3779B97F4A7C15) + np.uint64(mix)
        v ^= v >> np.uint64(29)
        v *= np.uint64(0xBF58476D1CE4E5B9)
        v ^= v >> np.uint64(32)
        out[:, h] = (v % np.uint64(m_bits)).astype(np.int64)
    return out


class PudBloomFilter:
    """Bloom filter whose bit array is a PuD bit-plane (on the engine's
    device).  Keys are host numpy arrays (uint64); per-key answers come
    back as bool tensors on the engine's device."""

    def __init__(self, m_bits: int = 1 << 20, n_hashes: int = 4, *,
                 engine: PudEngine | None = None, seed: int = 0):
        if m_bits % 32:
            raise ValueError(f"m_bits must be a multiple of 32, got {m_bits}")
        if n_hashes < 2:
            raise ValueError(f"n_hashes must be >= 2, got {n_hashes}")
        self.m_bits = m_bits
        self.n_hashes = n_hashes
        self.seed = seed
        self.engine = engine or PudEngine()
        self.device = self.engine.device
        self.plane = torch.zeros((1, m_bits // 32), dtype=torch.int32,
                                 device=self.device)

    def _positions(self, keys: np.ndarray) -> torch.Tensor:
        """(N, n_hashes) bit positions of a batch of keys, on the device."""
        pos = _hash_positions(keys, self.n_hashes, self.m_bits, self.seed)
        return torch.from_numpy(pos).to(self.device)

    def _bits(self) -> torch.Tensor:
        return kops.unpack_bits(self.plane)[0]

    def _hash_planes(self, keys: np.ndarray) -> dict[str, torch.Tensor]:
        """One (1, m_bits/32) plane per hash function: bit ``pos(k, h)``
        set for every key k of the batch."""
        pos = self._positions(keys)
        planes = {}
        for h in range(self.n_hashes):
            bits = torch.zeros(self.m_bits, dtype=torch.uint8,
                               device=self.device)
            bits[pos[:, h]] = 1
            planes[f"h{h}"] = pack_lanes(bits)
        return planes

    def insert(self, keys: np.ndarray) -> None:
        """Bulk OR-accumulate the per-hash planes of a batch of keys:
        one compiled many-input OR through ``engine.run_program``."""
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.size == 0:
            return
        planes = {"plane": self.plane} | self._hash_planes(keys)
        out = self.engine.run_program(
            bloom_insert_program(self.n_hashes), planes)
        self.plane = out["out"]

    def probe(self, keys: np.ndarray) -> torch.Tensor:
        """-> bool per key via the compiled many-input AND-reduce of the
        gathered per-hash membership bits (one bit lane per key)."""
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.size == 0:
            return torch.zeros(0, dtype=torch.bool, device=self.device)
        pos = self._positions(keys)
        bits = self._bits()
        gathered = {f"h{h}": pack_lanes(bits[pos[:, h]])
                    for h in range(self.n_hashes)}
        out = self.engine.run_program(
            bloom_probe_program(self.n_hashes), gathered)
        return unpack_lanes(out["out"], len(keys)).bool()

    def contains(self, keys: np.ndarray) -> torch.Tensor:
        """-> bool per key: all n_hashes bits set (a direct AND-probe on
        the device; :meth:`probe` is the engine-compiled twin)."""
        keys = np.asarray(keys, dtype=np.uint64)
        return self._bits()[self._positions(keys)].bool().all(dim=1)

    def filter_new(self, keys: np.ndarray) -> torch.Tensor:
        """-> mask of keys NOT already present; inserts them."""
        keys = np.asarray(keys)
        new = ~self.contains(keys)
        if new.any():   # all-duplicate batches issue zero engine ops
            self.insert(keys[new.cpu().numpy()])
        return new

    @property
    def fill_fraction(self) -> float:
        return int(self._bits().sum()) / self.m_bits
