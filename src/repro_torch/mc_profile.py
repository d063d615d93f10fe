"""Where the time of the port's main path goes, on one CUDA device.

    python -m repro_torch.mc_profile [--out chiprun_out/mc_profile.json]

For each cell (a Monte-Carlo call at the paper's scale: 10,000 trials on
the native 8192-bit row; the ``_b16`` cells deal 48 stratified groups over
16 banks, run as the per-bank loop and as 3 fused rounds) it records the
wall time of one call (host clock
around work that ends in a synchronize; median of ``REPS``), then traces
one more call with ``torch.profiler`` and reports the device time per
kernel, the summed device time and the device's busy share: summed device
time over the untraced median wall time (one stream, so kernels do not
overlap).  A throwaway trace first keeps the profiler's own start-up out
of the traced wall time.  Prints one JSON object and writes it to
``--out``.  Needs a CUDA device; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

TRIALS, ROW_BITS, REPS = 10_000, 8192, 5
#: name -> (kind, op, n, multi-bank options)
CELLS = {
    "nand16": ("boolean", "nand", 16, {}),
    "and2": ("boolean", "and", 2, {}),
    "not1": ("not", None, 1, {}),
    "not32": ("not", None, 32, {}),
    "nand16_b16_loop": ("boolean", "nand", 16,
                        dict(banks=16, groups=48, fused=False)),
    "nand16_b16_fused": ("boolean", "nand", 16,
                         dict(banks=16, groups=48, fused=True)),
}


def _call(kind, op, n, multi):
    from .core import charz
    kw = dict(trials=TRIALS, row_bits=ROW_BITS, device="cuda", **multi)
    if kind == "boolean":
        return charz.mc_boolean_success(op, n, **kw)
    return charz.mc_not_success(n, **kw)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def measure(fn, reps: int = REPS, *, every_kernel: bool = False) -> dict:
    """Wall (median of ``reps`` untraced calls after a warm-up) and device
    time per kernel (one traced call) of ``fn()`` on the card: the 12
    largest, and with ``every_kernel`` all of them (``"kernels"``)."""
    fn()                                            # warm-up
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    traced_wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = {"device_ms": us / 1e3,
                                "count": int(evt.count)}
    device_ms = sum(k["device_ms"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])
               [:12])
    wall_ms = statistics.median(walls) * 1e3
    return {"wall_ms": [w * 1e3 for w in walls],
            "wall_ms_median": wall_ms,
            "traced_wall_ms": traced_wall * 1e3,
            "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top_kernels": top, **({"kernels": kernels} if every_kernel
                                   else {})}


def profile_cell(kind, op, n, multi) -> dict:
    return measure(lambda: _call(kind, op, n, multi))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/mc_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mc_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"card": smi, "trials": TRIALS, "row_bits": ROW_BITS,
           "cells": {name: profile_cell(*cell)
                     for name, cell in CELLS.items()}}
    text = json.dumps(out, indent=1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
