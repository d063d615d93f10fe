"""Traffic kind ``toy_gemm``: a fixture of the benchmark's own tests, copied
into a copy of the checkout to show that a kind of cell unlike the
Monte-Carlo joins by new files and entries alone.  It is no cell of the
benchmark.

``setup`` makes the weights, an ``(n_out, k_bits)`` matrix of bits, from
the run's seed.  A call draws ``(rows, k_bits)`` activation bits from its
own seed and multiplies them through the program's binary GEMM
(``repro_torch.kernels.ops.popcount_gemm_bits``, AND counts; its plain twin
on the CPU); its answer is a digest of the ``(rows, n_out)`` counts.  The
judgement restates the product in numpy, in int64, for each drawn call:
``digest_mismatch`` counts the drawn calls whose digest differs, limit 0.
The control multiplies in bfloat16, which rounds counts above 256, so it is
caught where ``k_bits`` makes the counts that large.
"""
from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

LIMITS = {"digest_mismatch": 0}
#: the CPU tests' sizes: counts of about 64, which bfloat16 holds exactly
SMALL = {"k_bits": 256, "n_out": 32}
SMALL_ROWS = 16
#: the CPU tests' width at which the bfloat16 control is caught (counts of
#: about 512, which bfloat16 rounds to a multiple of 4)
CONTROL_K_BITS = 2048


def _bits(seed: int, shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    return torch.randint(0, 2, shape, generator=gen, device=device,
                         dtype=torch.uint8)


def digest(counts: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        counts, dtype=np.int32).tobytes()).hexdigest()[:16]


def answer_altered(monkeypatch) -> None:
    """The program's packed GEMM hands back its first count one too high."""
    from repro_torch.kernels import ops
    gemm = ops.popcount_gemm

    def altered(*a, **k):
        out = gemm(*a, **k).clone()
        out.view(-1)[0] += 1
        return out

    monkeypatch.setattr(ops, "popcount_gemm", altered)


class ToyGemm:
    """The program's product (``dtype`` None) or the control's, in
    ``dtype``.  ``events`` records each ``setup`` and ``call`` with its
    seed, in order."""

    faults = (answer_altered,)

    def __init__(self, dtype: torch.dtype | None = None):
        self.dtype = dtype
        self.weights = None
        self.events: list[tuple[str, int]] = []

    def setup(self, cfg, mix, seed, device) -> None:
        self.events.append(("setup", seed))
        self.weights = _bits(seed, (cfg["n_out"], cfg["k_bits"]), device)

    def _inputs(self, cfg, mix, seed, device) -> torch.Tensor:
        return _bits(seed, (mix["rows"], cfg["k_bits"]), device)

    def call(self, cfg, mix, seed, device) -> str:
        self.events.append(("call", seed))
        x = self._inputs(cfg, mix, seed, device)
        if self.dtype is None:
            from repro_torch.kernels import ops
            counts = ops.popcount_gemm_bits(x, self.weights, kind="and")
        else:
            counts = (x.to(self.dtype) @ self.weights.to(self.dtype).T).to(
                torch.int32)
        return digest(counts.cpu().numpy())

    def judge(self, cfg, mix, calls, device, log=sys.stderr) -> dict:
        w = self.weights.cpu().numpy().astype(np.int64)
        bad = 0
        for seed, got in calls:
            x = self._inputs(cfg, mix, seed, device).cpu().numpy()
            want = digest(x.astype(np.int64) @ w.T)
            bad += got != want
            print(f"[digest] seed {seed}: program {got}, reference {want}",
                  file=log)
        return {"digest_mismatch": {"value": bad,
                                    "limit": LIMITS["digest_mismatch"]}}

    def control(self) -> ToyGemm:
        return ToyGemm(torch.bfloat16)

    def small(self, cfg, mix):
        return dict(cfg, **SMALL), dict(mix, rows=SMALL_ROWS)

    def small_control(self, cfg, mix):
        cfg, mix = self.small(cfg, mix)
        return dict(cfg, k_bits=CONTROL_K_BITS), mix


DRIVER = ToyGemm()
