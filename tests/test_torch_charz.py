"""Port Monte-Carlo characterization (CPU) against the reference.

``draws="numpy"`` must reproduce the reference bit for bit (the seed canary
and the batched estimates); ``draws="device"`` must land in the reference's
Monte-Carlo band; the closed-form torch twin must match the numpy model.
Also: the port imports neither jax nor ``repro``, and never runs on the CPU
unless asked.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import analog as RA
from repro.core import analog_jax as AJ
from repro.core import calibrate as C
from repro.core import charz as RC
from repro_torch.core import analog_torch as AT
from repro_torch.core import charz as TC

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
NP = dict(draws="numpy", device="cpu")


def test_seed_canary_exact():
    """The reference's per-trial seed canary, through the port."""
    got = TC.mc_boolean_success("and", 16, trials=50, row_bits=2048,
                                batched=False, **NP)
    assert got == 0.95564453125


@pytest.mark.parametrize("op,n", [("and", 2), ("nor", 4), ("nand", 16),
                                  ("or", 8)])
def test_batched_boolean_equals_reference(op, n):
    kw = dict(trials=108, row_bits=1024, seed=2)
    assert TC.mc_boolean_success(op, n, **kw, **NP) == \
        RC.mc_boolean_success(op, n, **kw)


@pytest.mark.parametrize("n_dst", [1, 2, 32])
def test_batched_not_equals_reference(n_dst):
    kw = dict(trials=108, row_bits=1024, seed=4)
    assert TC.mc_not_success(n_dst, **kw, **NP) == \
        RC.mc_not_success(n_dst, **kw)


def test_per_trial_not_equals_reference():
    kw = dict(trials=12, row_bits=512, seed=1, batched=False)
    assert TC.mc_not_success(2, **kw, **NP) == RC.mc_not_success(2, **kw)


@pytest.mark.parametrize("batched", [True, False])
def test_cell_maps_equal_reference(batched):
    kw = dict(row_bits=512, seed=9, batched=batched)
    t = 100 if batched else 12
    assert np.array_equal(
        TC.measure_cell_map("and", 2, trials=t, **kw, **NP).numpy(),
        RC.measure_cell_map("and", 2, trials=t, **kw))
    assert np.array_equal(
        TC.measure_cell_map_not(trials=t, **kw, **NP).numpy(),
        RC.measure_cell_map_not(trials=t, **kw))


@pytest.mark.parametrize("which,dealer", [("and", "round_robin"),
                                          ("not", "round_robin"),
                                          ("and", "occupancy")])
def test_two_banks_equal_reference(which, dealer):
    """banks=2: the port's per-bank loop == the reference (which fuses the
    banks under round-robin dealing, bit-identically to its own loop)."""
    kw = dict(trials=108, row_bits=1024, banks=2, dealer=dealer)
    if which == "and":
        assert TC.mc_boolean_success("and", 4, **kw, **NP) == \
            RC.mc_boolean_success("and", 4, **kw)
    else:
        assert TC.mc_not_success(2, **kw, **NP) == \
            RC.mc_not_success(2, **kw)


@pytest.mark.parametrize("point", ["and16_b4", "not4_b4", "and16_b16"])
def test_multibank_matches_committed_benchmark(point):
    """The per-bank loop reproduces the reference's committed multi-bank
    results (BENCH_pr10.json ``fused_detail``: 192 trials, 48 groups)."""
    want = json.loads((ROOT / "BENCH_pr10.json").read_text())[
        "fused_detail"][point]
    kw = dict(trials=want["trials"], groups=want["groups"],
              banks=want["banks"], **NP)
    got = (TC.mc_boolean_success("and", 16, **kw) if point.startswith("and")
           else TC.mc_not_success(4, **kw))
    assert got == want["loop_success"] == want["fused_success"]


@pytest.mark.parametrize("op,n", [("and", 2), ("or", 4), ("and", 16)])
def test_device_draws_within_mc_band(op, n):
    """draws="device" (torch generators): within 3 pts of the calibrated
    model, the reference's own batched-MC band."""
    got = 100.0 * TC.mc_boolean_success(op, n, trials=432, row_bits=2048,
                                        seed=1, device="cpu")
    want = C._avg(op, n, RA.DEFAULT_PARAMS, die_rev="M", density_gb=4)
    assert abs(got - want) < 3.0, (op, n, got, want)


def test_fig15_and_fig7_mc_rows():
    d15 = TC.fig15_ops_vs_inputs(mc=False)
    assert d15["paper_16"] == RC.fig15_ops_vs_inputs(mc=False)["paper_16"]
    for op in TC.OPS:
        for n in TC.NS:
            assert d15[op][n] == RC.fig15_ops_vs_inputs()[op][n]
    d7 = TC.fig7_not_vs_dst_rows(mc=True, trials=9, **NP)
    r7 = RC.fig7_not_vs_dst_rows(mc=True, trials=9)
    assert d7 == r7


def test_unported_options_raise():
    """Nothing of the MC is unported any more: ``fused=True`` (the fused
    multi-bank path) equals the reference's default, which fuses too;
    ``stats=`` is held to the reference in test_torch_analysis.py."""
    kw = dict(trials=18, row_bits=512, seed=2, banks=2)
    assert TC.mc_boolean_success("and", 2, fused=True, **kw, **NP) == \
        RC.mc_boolean_success("and", 2, **kw)
    assert TC.mc_not_success(1, fused=True, **kw, **NP) == \
        RC.mc_not_success(1, **kw)


def test_torch_closed_form_matches_numpy():
    worst = 0.0
    for op in ("and", "nand", "or", "nor"):
        for n in (2, 4, 8, 16):
            a = RA.boolean_success_avg(op, n)
            worst = max(worst, abs(a - AT.boolean_success_avg(
                op, n, device="cpu")))
            worst = max(worst, abs(AJ.boolean_success_avg(op, n)
                                   - AT.boolean_success_avg(
                                       op, n, device="cpu")))
    assert worst < 1e-6, worst


def test_model_samplers_match_closed_form():
    closed = RA.boolean_success_avg("and", 4)
    sampled = TC.model_boolean_success("and", 4, trials=4000, width=512,
                                       device="cpu")
    assert abs(sampled - closed) < 0.01, (sampled, closed)
    closed = RA.not_success(2)
    sampled = TC.model_not_success(2, trials=4000, width=512, device="cpu")
    assert abs(sampled - closed) < 0.01, (sampled, closed)


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.core.charz, "
            "repro_torch.kernels.ops, repro_torch.convert, "
            "repro_torch.core.analog_torch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("entry", ["boolean", "not", "cell_map", "sampler",
                                   "bank"])
def test_no_silent_cpu(entry):
    """Without a CUDA device, an entry point called without device= raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    from repro_torch.core.simulator import BankSim
    calls = {"boolean": lambda: TC.mc_boolean_success("and", 2, trials=9),
             "not": lambda: TC.mc_not_success(1, trials=9),
             "cell_map": lambda: TC.measure_cell_map("and", 2, trials=9),
             "sampler": lambda: TC.model_boolean_success("and", 2),
             "bank": lambda: BankSim(row_bits=64)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
