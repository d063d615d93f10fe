"""The plain reference against the program's entry points on the CPU, at
a small size, and the control (the reference in the precision below the
configuration's, in the program's place) caught by a run's own judgement,
at the size its driver names."""
import io

import pytest
import torch

from bench import harness
from bench.conftest import CASES, cells_of_kind, driver_of, small_copy
from bench.manifest import Manifest
from bench.mcjudge import McDriver

#: a window's first call on a small seed, and a later one on a seed past
#: 32 bits, as the benchmark's seeds are
SEEDS = [harness.call_seed(3, 0), harness.call_seed(2**31 + 12345, 7)]


def _cell(root, name):
    c = Manifest(root).cell(name)
    return c, driver_of(c)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", cells_of_kind(McDriver))
def test_reference_equals_the_entry_point_bit_for_bit(small_checkout, name,
                                                      seed):
    c, driver = _cell(small_checkout, name)
    rate, rows = driver.answer(c.config, c.traffic, seed, "cpu")
    ref_rate, ref_rows = driver.reference(c.config, c.traffic, seed, "cpu")
    assert rate == ref_rate
    assert rows.shape == ref_rows.shape
    assert torch.equal(rows, ref_rows)


def test_every_call_of_a_run_is_a_new_chip():
    seeds = [harness.call_seed(2**31 + 5, i) for i in range(64)]
    warm = [harness.warmup_seed(2**31 + 5, i) for i in range(4)]
    assert len(set(seeds + warm)) == 68
    assert all(0 <= s < 2**63 for s in seeds + warm)
    assert seeds == [harness.call_seed(2**31 + 5, i) for i in range(64)]


@pytest.mark.parametrize("toy, name", CASES)
def test_the_control_in_bfloat16_is_caught(tmp_path, toy, name):
    """At the size its driver's ``small_control`` names, a run with the
    control in the program's place comes out not correct through the run's
    own judgement, on every seed tried."""
    c, driver = _cell(small_copy(tmp_path, toy), name)
    c.config, c.traffic = driver.small_control(c.config, c.traffic)
    for seed in (3, 2**31 + 12345):
        result = harness.run_cell(c, seed, 0.0, False, device="cpu",
                                  log=io.StringIO(), driver=driver.control())
        assert result["correct"] is False
        assert any(v["value"] > v["limit"] for v in result["checks"].values())


@pytest.mark.parametrize("name", cells_of_kind(McDriver))
def test_the_mc_control_misses_both_numbers(small_checkout, name):
    """The MC control at its size, on one call: its rate and its rows both
    differ from the reference's."""
    c, driver = _cell(small_checkout, name)
    cfg, mix = driver.small_control(c.config, c.traffic)
    control, seed = driver.control(), SEEDS[0]
    checks = control.judge(cfg, mix, [(seed, control.call(cfg, mix, seed,
                                                          "cpu"))],
                           "cpu", io.StringIO())
    assert checks["row_mismatch"]["value"] > 0
    assert checks["rate_gap"]["value"] > 0
