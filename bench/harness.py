"""One run of one cell: set-up, the timed window, the judgement, one line.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The traffic is a closed loop with one caller, as a researcher's sweep
script waits for each answer before it asks for the next: each call starts
when the last has returned and synchronized.  Call ``i`` of the window runs
on the seed :func:`call_seed` derives from ``--seed`` and ``i``, so every
call is a new chip with new draws, at the same sizes; set-up's warm-up
calls run on seeds outside that series (:func:`warmup_seed`), after the
driver's ``setup``, where it has one, on ``--seed`` itself.

``--trace 0`` times calls for ``--seconds`` and reports the cell's
end-to-end metrics.  ``--trace 1`` traces a shorter window with
``torch.profiler``, counts the host's reads of device data over one more
call, times a short untraced stretch of further calls, and reports the
cell's per-layer metrics, ``busy_s`` / ``window_s`` and the
``breakdown``.  Either way, once the window has closed and the
memory peak is read, the harness draws from ``--seed`` a sample of the
window's calls (the mix's ``check_calls``; every call that failed besides)
and hands it to the driver's ``judge`` (``bench/drivers/<kind>.py``), which
holds each answer against the plain reference for that call's own seed and
returns the numbers compared with their limits.  The run is correct where
every number is within its limit.  The last line of standard output is the
result.
"""
from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from bench import program, syncs, timeline
from bench.manifest import Cell, Manifest, ManifestError, load_module

#: top-level module names that the program's process must not hold: the JAX
#: stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: warm-up calls in set-up, of the window's own shape
WARMUP_CALLS = 1
#: calls the judgement draws from a window, where the mix names no number
CHECK_CALLS = 4
#: the traced window's length at most (a trace of every op stays small)
TRACE_SECONDS = 2.0
#: the untraced stretch of a traced run, at most (at least one call): the
#: calls' walls without the profiler, for per-layer readings of call time
UNTRACED_SECONDS = 6.0


def forbidden_modules(modules=None) -> list[str]:
    """Forbidden top-level names among ``modules`` (``sys.modules``),
    compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _derive(seed: int, stream: int, i: int) -> int:
    state = np.random.SeedSequence([seed % (1 << 64), stream, i])
    return int(state.generate_state(1, np.uint64)[0] >> 1)


def call_seed(seed: int, i: int) -> int:
    """The 63-bit seed of the window's ``i``-th call in a run on ``seed``."""
    return _derive(seed, 0xCA11, i)


def warmup_seed(seed: int, i: int) -> int:
    """The seed of set-up's ``i``-th warm-up call: outside the calls'
    series."""
    return _derive(seed, 0x3A2E, i)


def judged(calls: list, seed: int, k: int) -> list:
    """The calls the judgement compares: ``k`` of those answered, drawn
    from ``seed``, in window order, then every call that failed."""
    done = [c for c in calls if c[1] is not None]
    pick = sorted(random.Random(seed).sample(range(len(done)),
                                             min(k, len(done))))
    return [done[i] for i in pick] + [c for c in calls if c[1] is None]


@dataclass
class Context:
    """What the metric readers read (``bench/metrics/<name>.py``)."""

    setup_s: float = 0.0
    window_s: float = 0.0
    walls: list = field(default_factory=list)
    n_calls: int = 0
    memory_peak_bytes: int = 0
    trace: dict | None = None
    traced_calls: int = 0
    busy_s: float = 0.0
    window_trace_s: float = 0.0
    host_reads: int = 0
    host_read_calls: int = 0
    launches: dict = field(default_factory=dict)
    apas: list = field(default_factory=list)
    #: the cell itself, for a reader that needs its own shapes and counts
    driver: object = None
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize()


def _timed(fn, seed: int, seconds: float, device, span: bool = False,
           first: int = 0):
    """Call ``fn(call_seed(seed, i))`` for i = first, first + 1, ... back to
    back until ``seconds`` have passed (at least once).  -> (calls as ``(seed,
    answer)``, walls, failed, window seconds); a call that fails ends the
    window, its answer None."""
    calls, walls, failed = [], [], 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while not calls or time.perf_counter() < end:
        s = call_seed(seed, first + len(calls))
        t = time.perf_counter()
        try:
            if span:
                with torch.profiler.record_function(timeline.CALL_SPAN):
                    r = fn(s)
                    _sync(device)
            else:
                r = fn(s)
                _sync(device)
        except Exception:
            traceback.print_exc()
            calls.append((s, None))
            failed += 1
            break
        walls.append(time.perf_counter() - t)
        calls.append((s, r))
    return calls, walls, failed, time.perf_counter() - t0


def _card(device) -> str:
    if not _on_card(device):
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or torch.cuda.get_device_name(0)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start: float | None = None,
             log=sys.stderr, driver=None) -> dict:
    """One run of ``cell``; -> the result object (the last line's keys).
    ``driver`` puts another driver in the traffic's place (the control).
    The driver's ``setup``, where it has one, runs once on ``seed`` before
    the warm-up calls (``bench/drivers/__init__.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    if driver is None:
        driver = load_module(cell.driver, cell.traffic["driver"]).DRIVER
    cfg, mix = cell.config, cell.traffic

    def call(s):
        return driver.call(cfg, mix, s, device)

    t_first = time.perf_counter()
    made = ""
    if hasattr(driver, "setup"):
        driver.setup(cfg, mix, seed, device)
        _sync(device)
        made = f"the driver's set-up {time.perf_counter() - t_first:.3f} s, "
    warm = []
    for w in range(WARMUP_CALLS):
        t = time.perf_counter()
        call(warmup_seed(seed, w))
        _sync(device)
        warm.append(time.perf_counter() - t)
    print(f"[setup] {t_first - t_start:.3f} s to the first call, {made}"
          f"warm-up calls {', '.join(f'{w:.3f}' for w in warm)} s", file=log)
    ctx = Context(setup_s=time.perf_counter() - t_start,
                  apas=driver.apas(cfg, mix) if hasattr(driver, "apas")
                  else [], driver=driver, config=cfg, traffic=mix)
    if not traced:
        calls, walls, failed, window = _timed(call, seed, seconds, device)
        ctx.walls, ctx.n_calls, ctx.window_s = walls, len(walls), window
        if walls:
            print(f"[calls] {len(walls)} in {window:.3f} s; the first three "
                  f"{', '.join(f'{w * 1e3:.3f}' for w in walls[:3])} ms, "
                  f"the median {float(np.median(walls)) * 1e3:.3f} ms",
                  file=log)
    else:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if _on_card(device):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):   # profiler start-up
            torch.ones(1, device=device).add_(1)
            _sync(device)
        before = program.launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            calls, walls, failed, window = _timed(
                call, seed, min(seconds, TRACE_SECONDS), device, span=True)
        after = program.launch_counts()
        ctx.launches = {k: v - before.get(k, 0) for k, v in after.items()}
        ctx.trace = timeline.read(prof)
        ctx.traced_calls = ctx.trace["calls"]
        ctx.window_trace_s = ctx.trace["window"][1] - ctx.trace["window"][0]
        ctx.busy_s = timeline.busy_s(ctx.trace["device"], ctx.trace["window"])
        if not failed:
            with syncs.HostReads() as reads:
                call(call_seed(seed, len(calls)))
            ctx.host_reads, ctx.host_read_calls = reads.reads, 1
            more, walls, failed, window = _timed(
                call, seed, min(seconds, UNTRACED_SECONDS), device,
                first=len(calls) + 1)
            calls += more
            ctx.walls, ctx.n_calls, ctx.window_s = walls, len(walls), window
            print(f"[untraced] {len(walls)} calls in {window:.3f} s",
                  file=log)
    if _on_card(device):
        ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    result = {"correct": False, "attempted": len(calls), "failed": failed}
    checks = driver.judge(cfg, mix, judged(calls, seed, mix.get(
        "check_calls", CHECK_CALLS)), device, log)
    result["correct"] = (failed == 0 and bool(calls)
                         and all(c["value"] <= c["limit"]
                                 for c in checks.values()))
    metrics = cell.per_layer if traced else cell.end_to_end
    result["metrics"] = {}
    for m in metrics:
        value = load_module(cell.readers[m["name"]], m["name"]).read(ctx)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if _on_card(device) else "cpu",
           "kind": torch.cuda.get_device_name(0) if _on_card(device)
           else "cpu",
           "count": cell.chips, "memory_peak_bytes": ctx.memory_peak_bytes}
    if traced:
        dev.update(busy_s=ctx.busy_s, window_s=ctx.window_trace_s)
        result["breakdown"] = timeline.breakdown(ctx.trace)
    result["device"] = dev
    print(f"[card] {_card(device)}", file=log)
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=log)
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Manifest().cell(args.workload)
    except ManifestError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process holds {bad} after the window",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
