"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

The main path is the paper's characterization Monte-Carlo: trial-batched
APAs on the torch ``BankSim`` through ``PudIsa``, resolved by the hand-written
sense-amp kernel, giving the success rates of Fig. 15 (16-input
AND/NAND/OR/NOR) and Fig. 7 (NOT) at the paper's scale — 10,000 trials per
configuration on the native 8192-bit row.  Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the kernel from ``src/repro_torch/kernels/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card, bit for bit,
   at the main path's shapes, with its time beside its bound;
4. the main path through ``charz.mc_boolean_success`` / ``mc_not_success``
   with the launch counts reset just before and read just after; the rates
   are held to the paper and to the closed-form model;
5. ``draws="numpy"`` on the card against the same run on the CPU (equal);
6. the closed-form sampler on the card.

Any failed check raises and the script exits non-zero.  The second-to-last
line is the kernel table as JSON; the last line is the device record.  With
no CUDA device, or without the repository's ``src/`` beside it, it exits
non-zero before printing a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PAPER_16 = {"and": 0.9494, "nand": 0.9494, "or": 0.9585, "nor": 0.9587}
PAPER_NOT1 = 0.9837
TRIALS, ROW_BITS = 10_000, 8192


def _phase(name: str, t0: float, times: dict) -> float:
    now = time.perf_counter()
    times[name] = round(now - t0, 3)
    print(f"[phase] {name}: {times[name]} s", flush=True)
    return now


def _time_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around ``reps`` back-to-back
    calls after a warm-up, over the count (the queue stays full, so the
    host's launch cost is hidden wherever the device is the slower side)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_senseamp(S) -> dict:
    """Gather kernel vs plain twin at the nand16 main-path shape."""
    tg = -(-TRIALS // 9)                 # trials per stratified pair group
    w, n, slots = ROW_BITS // 2, 16, 16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows_l = [int(r) for r in np.random.default_rng(0).permutation(slots)[:n]]
    rows_f = list(range(slots))[::-1][:n]
    normals = torch.randn((tg, w), generator=gen, device=dev)
    u0 = torch.rand((tg, w), generator=gen, device=dev)
    static = 0.02 * torch.randn((w,), generator=gen, device=dev)
    scal = dict(width=w, u_com=1 / 22, u_ref=1 / 22, sigma=0.0061, pf=0.0431,
                thr=0.0123)
    worst = 0
    cases = {}
    for kind in ("ternary", "float"):
        if kind == "ternary":
            cells = [torch.randint(0, 3, (tg, slots, ROW_BITS), generator=gen,
                                   device=dev).float() * 0.5
                     for _ in range(2)]
        else:
            cells = [torch.rand((tg, slots, ROW_BITS), generator=gen,
                                device=dev) for _ in range(2)]
        args = (cells[1], rows_l, w, cells[0], rows_f, 0)
        kw = dict(static=static, normals=normals, u0=u0, **scal)
        got = S.senseamp_gather_cuda(*args, **kw)
        want = S.senseamp_gather_plain(*args, **kw)
        torch.cuda.synchronize()
        diff = int((got.int() - want.int()).abs().max())
        worst = max(worst, diff)
        assert diff == 0, f"senseamp kernel != plain ({kind} cells)"
        cases[kind] = (args, kw)
    # scalar mode on the card: float64 draws cast to float32, two uniforms
    # per lane; plus a (T, W) static plane and ideal mode (no noise)
    g64 = torch.Generator(device=dev)
    g64.manual_seed(99)
    args = cases["ternary"][0]
    one = tuple(x[:1] if torch.is_tensor(x) else x for x in args)
    extra = {
        "scalar": (one, dict(static=static.double().float(),
                             normals=torch.randn((1, w), generator=g64,
                                                 device=dev,
                                                 dtype=torch.float64).float(),
                             u0=torch.rand((1, w), generator=g64, device=dev,
                                           dtype=torch.float64).float(),
                             u1=torch.rand((1, w), generator=g64, device=dev,
                                           dtype=torch.float64).float(),
                             **scal)),
        "static_plane": (args, dict(cases["ternary"][1],
                                    static=0.02 * torch.randn(
                                        (tg, w), generator=gen, device=dev))),
        "ideal": (args, dict(width=w, u_com=1 / 22, u_ref=1 / 22)),
    }
    for kind, (a, kw) in extra.items():
        got = S.senseamp_gather_cuda(*a, **kw)
        want = S.senseamp_gather_plain(*a, **kw)
        diff = int((got.int() - want.int()).abs().max())
        worst = max(worst, diff)
        assert diff == 0, f"senseamp kernel != plain ({kind})"
    # the slab front end (identity slots) on the card == on the CPU
    from repro_torch.kernels import ops
    t, nn = 64, 5
    slab = dict(u_com=.09, u_ref=.11, shift=.015, pf=.03, trial_sigma=.01)
    ins = [torch.rand((t, nn, w), generator=gen, device=dev),
           torch.rand((t, nn + 2, w), generator=gen, device=dev),
           0.02 * torch.randn((w,), generator=gen, device=dev),
           torch.randn((t, w), generator=gen, device=dev),
           torch.rand((2, t, w), generator=gen, device=dev)]
    before = S.launches
    got = ops.senseamp_resolve_trials(*ins, **slab)
    assert S.launches == before + 1
    want = ops.senseamp_resolve_trials(*(x.cpu() for x in ins), **slab)
    diff = int((got.cpu().int() - want.int()).abs().max())
    worst = max(worst, diff)
    assert diff == 0, "senseamp_resolve_trials: card != CPU"
    args, kw = cases["ternary"]
    ms = _time_ms(lambda: S.senseamp_gather_cuda(*args, **kw))
    plain_ms = _time_ms(lambda: S.senseamp_gather_plain(*args, **kw), reps=5)
    # bytes the function must move: each activated cell, the normal, the
    # uniform and the static offsets read once, each output bit written once
    nbytes = tg * w * (4 * (len(rows_l) + len(rows_f)) + 4 + 4 + 1) + 4 * w
    return {"name": "senseamp_resolve", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/senseamp.cu",
            "replaces": "src/repro/kernels/senseamp.py:77",
            "launches": None, "max_abs_err": float(worst),
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
            "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 6),
            "bound_by": "bytes", "library_ms": None,
            "shape": {"T": tg, "W": w, "n_com": n, "n_ref": n}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import analog as A
    from repro_torch.core import analog_torch as AT
    from repro_torch.core import charz
    from repro_torch.kernels import build
    from repro_torch.kernels import senseamp as S

    times: dict[str, float] = {}
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    t0 = _phase("nvidia_smi", t0, times)

    build.load("senseamp")
    t0 = _phase("build", t0, times)

    row = check_senseamp(S)
    print(f"[senseamp] kernel == plain bit for bit; kernel {row['ms']} ms, "
          f"plain {row['plain_ms']} ms, bound {row['bound_ms']} ms "
          f"({row['bound_by']}) at {row['shape']}", flush=True)
    t0 = _phase("kernel_vs_plain", t0, times)

    # ---- main path: the launch count covers exactly these calls ----
    S.launches = 0
    rates, peak = {}, {}
    for op in charz.OPS:
        for n in charz.NS:
            before = S.launches
            torch.cuda.reset_peak_memory_stats()
            r = charz.mc_boolean_success(op, n, trials=TRIALS,
                                         row_bits=ROW_BITS, device="cuda")
            peak[f"{op}{n}"] = torch.cuda.max_memory_allocated()
            rates[f"{op}{n}"] = r
            assert S.launches - before == charz.MC_PAIR_GROUPS, \
                (op, n, S.launches - before)
    for d in charz.NOT_DSTS:
        torch.cuda.reset_peak_memory_stats()
        rates[f"not{d}"] = charz.mc_not_success(d, trials=TRIALS,
                                                row_bits=ROW_BITS,
                                                device="cuda")
        peak[f"not{d}"] = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    row["launches"] = S.launches
    t0 = _phase("main_path", t0, times)
    assert row["launches"] > 0
    for op, paper in PAPER_16.items():
        got = rates[f"{op}16"]
        closed = float(np.mean(A.boolean_success_avg_grid(
            op, 16, die_rev="M", density_gb=4)))
        print(f"[fig15] {op}16 mc {got} paper {paper} closed {closed}",
              flush=True)
        assert abs(got - paper) < 0.04, (op, got, paper)
        assert abs(got - closed) < 0.015, (op, got, closed)
        assert got > rates[f"{op}2"], (op, got, rates[f"{op}2"])
    print(f"[fig7] not1 mc {rates['not1']} paper {PAPER_NOT1}; not32 mc "
          f"{rates['not32']}", flush=True)
    assert abs(rates["not1"] - PAPER_NOT1) < 0.05
    assert rates["not32"] < 0.35
    print("[rates] " + json.dumps(rates), flush=True)
    print("[peak_bytes] " + json.dumps(peak), flush=True)

    # ---- the numpy-draw parity mode: card == CPU ----
    par = {}
    for name, fn in (("nand16", lambda dev: charz.mc_boolean_success(
                         "nand", 16, trials=108, row_bits=2048,
                         draws="numpy", device=dev)),
                     ("not1", lambda dev: charz.mc_not_success(
                         1, trials=108, row_bits=2048, draws="numpy",
                         device=dev))):
        par[name] = (fn("cuda"), fn("cpu"))
        assert par[name][0] == par[name][1], (name, par[name])
    print(f"[parity] draws=numpy cuda == cpu: {par}", flush=True)
    t0 = _phase("cross_device_parity", t0, times)

    sampled = AT.sample_boolean_success("and", 16, trials=TRIALS, width=4096,
                                        device="cuda")
    closed = A.boolean_success_avg("and", 16)
    assert abs(sampled - closed) < 0.01, (sampled, closed)
    print(f"[sampler] and16 sampled {sampled} closed {closed}", flush=True)
    t0 = _phase("sampler", t0, times)
    print("[times] " + json.dumps(times), flush=True)

    print(card)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
