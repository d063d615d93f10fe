"""The plain reference against the program's entry points on the CPU, at
a small size, and the control (the reference with its decision in
bfloat16, in the program's place) caught by a run's own judgement."""
import io

import pytest
import torch

from bench import harness
from bench.manifest import Manifest, load_module

CELLS = ["mc.nand16.b1", "mc.nand16.b16", "mc.not1.b1"]
#: a window's first call on a small seed, and a later one on a seed past
#: 32 bits, as the benchmark's seeds are
SEEDS = [harness.call_seed(3, 0), harness.call_seed(2**31 + 12345, 7)]


def _cell(root, name):
    c = Manifest(root).cell(name)
    return c, load_module(c.driver, c.traffic["driver"]).DRIVER


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
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


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_bfloat16_is_caught(small_checkout, name):
    """At a size a test holds (here 16x the other tests' rows), a run with
    the control in the program's place comes out not correct through the
    run's own judgement, on every seed tried."""
    c, driver = _cell(small_checkout, name)
    c.config["module"]["row_bits"] = 4096
    for seed in (3, 2**31 + 12345):
        result = harness.run_cell(c, seed, 0.0, False, device="cpu",
                                  log=io.StringIO(), driver=driver.control())
        assert result["correct"] is False
        assert result["checks"]["row_mismatch"]["value"] > 0
        assert result["checks"]["rate_gap"]["value"] > 0
