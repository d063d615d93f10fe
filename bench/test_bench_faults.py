"""A whole run on the CPU, the card's look skipped: sound, it is correct;
with the timed path broken underneath, ``correct`` comes out false.  Every
cell of the manifest, and the toy kind's on a copy with it added."""
import io

import pytest

from bench import harness
from bench.conftest import (CASES, FAULT_CASES, TOY_CELL, cells_of_kind,
                            driver_of, small_copy)
from bench.manifest import Manifest
from bench.mcjudge import McDriver


def _run(root, name, traced=False, driver=None, seed=11):
    log = io.StringIO()
    result = harness.run_cell(Manifest(root).cell(name), seed, 0.2, traced,
                              device="cpu", log=log, driver=driver)
    return result, log.getvalue().splitlines()


def _checks_last(result, lines) -> bool:
    """The numbers compared are the last lines of the log, in order."""
    checks = list(result["checks"])
    return bool(checks) and [ln.split()[1] for ln in
                             lines[-len(checks):]] == checks


@pytest.mark.parametrize("toy, name", CASES)
def test_a_sound_run_is_correct_and_prints_its_checks_last(tmp_path, toy,
                                                           name):
    root = small_copy(tmp_path, toy)
    result, lines = _run(root, name)
    assert result["correct"] and result["failed"] == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    # every end-to-end metric of the cell but the card's memory peak
    want = {m["name"] for m in Manifest(root).cell(name).end_to_end}
    assert set(result["metrics"]) == want - {"peak_mem_GiB"}
    assert _checks_last(result, lines)


@pytest.mark.parametrize("toy, name", CASES)
def test_a_traced_run_is_correct_and_reads_its_layers(tmp_path, toy, name):
    root = small_copy(tmp_path, toy)
    result, lines = _run(root, name, traced=True)
    assert result["correct"]
    cell = Manifest(root).cell(name)
    assert set(result["metrics"]) <= {x["name"] for x in cell.per_layer}
    assert any(ln.startswith("[untraced] ") for ln in lines)
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
    assert _checks_last(result, lines)


def test_setup_runs_once_on_the_run_seed_before_the_warm_up(tmp_path):
    """The toy kind makes its weights in ``setup``: once, on ``--seed``,
    before the warm-up call, with its time in the ``[setup]`` line."""
    root = small_copy(tmp_path, toy=True)
    driver, seed = driver_of(Manifest(root).cell(TOY_CELL)), 2**31 + 99
    result, lines = _run(root, TOY_CELL, driver=driver, seed=seed)
    assert result["correct"]
    assert driver.events[:3] == [("setup", seed),
                                 ("call", harness.warmup_seed(seed, 0)),
                                 ("call", harness.call_seed(seed, 0))]
    assert [e for e in driver.events if e[0] == "setup"] == [("setup", seed)]
    assert "the driver's set-up" in next(ln for ln in lines
                                         if ln.startswith("[setup] "))


@pytest.mark.parametrize("name", cells_of_kind(McDriver))
def test_a_traced_run_counts_host_reads(small_checkout, name):
    """On the CPU the plain twins launch no kernel.  A cell that reports
    its calls' untraced time per layer (``host_call_ms``) in place of the
    counts reads it above 0."""
    result, _lines = _run(small_checkout, name, traced=True)
    assert result["correct"]
    m = result["metrics"]
    cell = Manifest(small_checkout).cell(name)
    names = {x["name"] for x in cell.per_layer}
    reads = driver_of(cell).host_reads(cell.config, cell.traffic)
    assert m.get("host_syncs_per_call", {}).get("value") == (
        reads if "host_syncs_per_call" in names else None)
    assert m.get("senseamp_launches_per_call", {}).get("value") == (
        0 if "senseamp_launches_per_call" in names else None)
    if "host_call_ms" in names:
        assert m["host_call_ms"]["value"] > 0


@pytest.mark.parametrize("name", cells_of_kind(McDriver))
def test_the_mc_checks_are_rate_gap_and_row_mismatch(small_checkout, name):
    cell = Manifest(small_checkout).cell(name)
    driver = driver_of(cell)
    seed = harness.call_seed(11, 0)
    rate = driver.call(cell.config, cell.traffic, seed, "cpu")
    checks = driver.judge(cell.config, cell.traffic, [(seed, rate)], "cpu",
                          io.StringIO())
    assert checks == {"rate_gap": {"value": 0.0, "limit": 0.0},
                      "row_mismatch": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("toy, name, fault", FAULT_CASES)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, toy, name,
                                            fault):
    root = small_copy(tmp_path, toy)
    faults = {f.__name__: f for f in driver_of(Manifest(root).cell(name))
              .faults}
    faults[fault](monkeypatch)
    result, lines = _run(root, name)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    assert _checks_last(result, lines)


class _RaisesAfterWarmUp:
    """A cell's driver whose calls after set-up's warm-up raise."""

    def __init__(self, driver):
        self._driver, self._calls = driver, 0

    def __getattr__(self, name):
        return getattr(self._driver, name)

    def call(self, *a):
        self._calls += 1
        if self._calls > harness.WARMUP_CALLS:
            raise RuntimeError("planted")
        return self._driver.call(*a)


@pytest.mark.parametrize("toy, name", CASES)
def test_a_call_that_raises_ends_the_window_as_failed(tmp_path, toy, name):
    root = small_copy(tmp_path, toy)
    driver = _RaisesAfterWarmUp(driver_of(Manifest(root).cell(name)))
    result, _lines = _run(root, name, driver=driver)
    assert result["attempted"] == 1
    assert result["failed"] == 1 and result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
