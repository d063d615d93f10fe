"""The benchmark's arithmetic, worked by hand: the sense-amp roofline's
bytes and operations, the APA shapes a mix implies, and the idle share and
breakdown of a traced window."""
import json

import pytest

from bench import roofline, timeline
from bench.conftest import ROOT
from bench.manifest import Manifest, load_module

W = 4096        # shared columns of an 8192-bit row


def test_senseamp_bytes_and_operations_at_the_nand16_shape():
    # 1,112 trials (10,000 over 9 groups) x 4,096 columns, 16 + 16 rows:
    # 32 cells of 4 B, a normal and a uniform of 4 B, 1 B out per decision,
    # then one bank's 4,096 static offsets and its threshold
    nbytes, ops = roofline.senseamp_apa(1112, W, 16, 16)
    assert nbytes == 1112 * 4096 * 137 + 4096 * 4 + 4 == 624_017_412
    assert ops == 1112 * 4096 * (15 + 15 + 12)
    assert roofline.bound_s(nbytes, ops) == pytest.approx(0.186274e-3,
                                                          abs=1e-9)


def test_senseamp_bytes_at_the_fused_shape():
    # 16 banks x 209 trials stacked: a (16, W) static plane, 16 thresholds
    nbytes, _ops = roofline.senseamp_apa(16 * 209, W, 16, 16, banks=16)
    assert nbytes == 3344 * 4096 * 137 + 16 * (4096 * 4 + 4) \
        == 1_876_754_496
    assert roofline.bound_s(nbytes, 0) == pytest.approx(0.560225e-3,
                                                        abs=1e-9)


def test_the_operations_never_bound_these_shapes():
    nbytes, ops = roofline.senseamp_apa(1112, W, 2, 2)
    assert ops / roofline.PEAKS["fp32_ops_per_s"] \
        < nbytes / roofline.PEAKS["hbm_bytes_per_s"]


def _mc(config, traffic):
    """An MC configuration and mix of the benchmark, by their names, with
    the mix's driver."""
    m = Manifest(ROOT)
    cfg = json.loads((ROOT / m.configs[config]["file"]).read_text())
    mix = m.traffic(traffic)
    return cfg, mix, load_module(m.driver_path(mix["driver"]),
                                 mix["driver"]).DRIVER


B1, B16 = "hynix_4gb_m_2666.b1", "hynix_4gb_m_2666.b16"


@pytest.mark.parametrize("config, traffic, shapes, reads", [
    (B1, "nand16", [dict(T=1112, W=W, n_com=16, n_ref=16, banks=1)] * 9,
     18),
    (B16, "nand16.g48", [dict(T=3344, W=W, n_com=16, n_ref=16, banks=16)] * 3,
     6),
    (B1, "and2", [dict(T=1112, W=W, n_com=2, n_ref=2, banks=1)] * 9, 18),
    (B1, "not1", [], 9),
])
def test_the_apas_of_one_call(config, traffic, shapes, reads):
    """The resolves of one call, and its host reads: a score read a scored
    block (9 groups on one bank, 3 fused rounds on 16) and an op-context
    read a resolve."""
    cfg, mix, driver = _mc(config, traffic)
    assert driver.apas(cfg, mix) == shapes
    assert driver.host_reads(cfg, mix) == reads


def test_a_tail_round_fuses_the_remaining_banks():
    cfg, mix, driver = _mc(B16, "nand16.g48")
    got = driver.apas(cfg, dict(mix, groups=40, trials=4000))
    assert [a["banks"] for a in got] == [16, 16, 8]
    assert [a["T"] for a in got] == [1600, 1600, 800]


def test_idle_share_of_a_synthetic_window():
    window = (0.0, 10.0)
    # overlapping and nested ops merge; one runs past the window's end
    dev = [("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 2.5, 3.0),
           ("d", 6.0, 7.0), ("e", 9.5, 12.0)]
    assert timeline.merge([(s, e) for _n, s, e in dev], window) == \
        [(1.0, 4.0), (6.0, 7.0), (9.5, 10.0)]
    assert timeline.busy_s(dev, window) == pytest.approx(4.5)
    assert timeline.idle_gaps(dev, window) == \
        [(0.0, 1.0), (4.0, 6.0), (7.0, 9.5)]


def test_breakdown_names_ops_and_what_the_host_did_in_each_gap():
    tr = {"window": (0.0, 10.0),
          "device": [("k1", 1.0, 3.0), ("k2", 4.0, 5.0), ("k1", 6.0, 7.0)],
          "host": [("aten::index_put_", 3.0, 4.5), ("numpy", 5.0, 6.0),
                   ("aten::empty", 5.2, 5.4), ("sync", 7.0, 7.2)]}
    b = timeline.breakdown(tr)
    assert b["device_ops"] == [["k1", 3.0], ["k2", 1.0]]
    # gaps (0,1) (3,4) (5,6) (7,10): midpoints 0.5, 3.5, 5.5, 8.5
    assert b["idle_gaps"] == [[timeline.NO_OP, 4.0],
                              ["aten::index_put_", 1.0], ["numpy", 1.0]]


def test_the_per_layer_readings_of_a_fused_cell():
    from bench.harness import Context
    tr = {"window": (0.0, 1.0), "calls": 2,
          "device": [("senseamp_resolve", 0.1, 0.2), ("index_put_", 0.2, 0.5),
                     ("copy_", 0.6, 0.7)]}
    ctx = Context(trace=tr, traced_calls=2, window_s=6.6, n_calls=3)
    bench = ROOT / "bench" / "metrics"
    bank = load_module(bench / "bank_device_ms.py", "bank_device_ms")
    fused = load_module(bench / "bank_device_ms.fused.py",
                        "bank_device_ms.fused")
    # (0.3 + 0.1) s of the bank's ops over 2 calls; the kernel left out
    assert fused.read(ctx) == bank.read(ctx) == pytest.approx(200.0)
    host = load_module(bench / "host_call_ms.py", "host_call_ms")
    assert host.read(ctx) == pytest.approx(2200.0)
    assert host.read(Context()) is None
