"""A whole run on the CPU, the card's look skipped: sound, it is correct;
with the timed path broken underneath, ``correct`` comes out false."""
import io

import pytest

from bench import harness
from bench.manifest import Manifest

CELLS = ["mc.nand16.b1", "mc.nand16.b16", "mc.not1.b1"]


def _run(root, name, traced=False):
    log = io.StringIO()
    result = harness.run_cell(Manifest(root).cell(name), 11, 0.2, traced,
                              device="cpu", log=log)
    return result, log.getvalue().splitlines()


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_prints_its_checks_last(small_checkout,
                                                           name):
    result, lines = _run(small_checkout, name)
    assert result["correct"] and result["failed"] == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    # every end-to-end metric of the cell but the card's memory peak
    want = {m["name"] for m in Manifest(small_checkout).cell(name).end_to_end}
    assert set(result["metrics"]) == want - {"peak_mem_GiB"}
    assert [ln.split()[1] for ln in lines[-2:]] == ["rate_gap",
                                                    "row_mismatch"]


@pytest.mark.parametrize("name, reads, launches", [
    ("mc.nand16.b1", 18, 0), ("mc.nand16.b16", None, None),
    ("mc.not1.b1", 9, None)])
def test_a_traced_run_counts_host_reads(small_checkout, name, reads,
                                        launches):
    """On the CPU the plain twins launch no kernel.  ``mc.nand16.b16``
    reports its calls' untraced time per layer in place of the counts."""
    result, lines = _run(small_checkout, name, traced=True)
    assert result["correct"]
    m = result["metrics"]
    cell = Manifest(small_checkout).cell(name)
    assert set(m) <= {x["name"] for x in cell.per_layer}
    assert m.get("host_syncs_per_call", {}).get("value") == reads
    assert m.get("senseamp_launches_per_call", {}).get("value") == launches
    if "host_call_ms" in {x["name"] for x in cell.per_layer}:
        assert m["host_call_ms"]["value"] > 0
    assert any(ln.startswith("[untraced] ") for ln in lines)
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def _flip_one_result_bit(monkeypatch):
    from repro_torch.core.isa import PudIsa
    read = PudIsa._result_word

    def altered(self, *a, **k):
        word = read(self, *a, **k).clone()
        word.view(-1)[0] ^= 1
        return word

    monkeypatch.setattr(PudIsa, "_result_word", altered)


def _half_the_batch(monkeypatch):
    from repro_torch.core import charz
    for entry in ("mc_boolean_success", "mc_not_success"):
        full = getattr(charz, entry)

        def halved(*a, _full=full, **k):
            return _full(*a, **dict(k, trials=k["trials"] // 2))

        monkeypatch.setattr(charz, entry, halved)


@pytest.mark.parametrize("fault", [_flip_one_result_bit, _half_the_batch])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(small_checkout, monkeypatch,
                                            name, fault):
    fault(monkeypatch)
    result, lines = _run(small_checkout, name)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    assert lines[-1].startswith("[check] row_mismatch")


def test_a_call_that_raises_ends_the_window_as_failed(small_checkout,
                                                      monkeypatch):
    from repro_torch.core import charz

    def broken(*a, **k):
        raise RuntimeError("planted")

    c = Manifest(small_checkout).cell("mc.nand16.b1")
    calls = []
    real = charz.mc_boolean_success

    def once(*a, **k):           # set-up's warm-up calls pass, then it fails
        calls.append(1)
        return (real if len(calls) <= harness.WARMUP_CALLS else broken)(
            *a, **k)

    monkeypatch.setattr(charz, "mc_boolean_success", once)
    result = harness.run_cell(c, 11, 0.2, False, device="cpu",
                              log=io.StringIO())
    assert result["failed"] == 1 and result["correct"] is False
    assert result["checks"]["row_mismatch"]["value"] > 0
