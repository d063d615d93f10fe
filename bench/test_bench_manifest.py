"""The manifest: it parses, keeps the naming rules, and grows by files."""
import json
import re

import pytest

from bench.conftest import ROOT, copy_checkout
from bench.manifest import NAME_RE, UNIT_RE, Manifest, ManifestError

CELLS = ["mc.nand16.b1", "mc.nand16.b16", "mc.not1.b1"]


def test_manifest_parses_with_the_contract_keys():
    m = Manifest(ROOT)
    assert set(m.data) == {"command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"}
    assert m.data["command"] == ["python3", "bench/run.py"]
    assert m.data["paths"] == ["bench"]
    assert sorted(m.workloads) == sorted(CELLS)
    assert all(w["chips"] == 1 for w in m.workloads.values())
    for e in m.data["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert {e["name"] for e in m.data["end_to_end"]} >= {"setup_s"}


def test_names_and_units_use_the_allowed_characters():
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in d[k]]
    names += [w[k] for w in d["workloads"] for k in ("config", "traffic")]
    names += [key for c in d["configs"] for key in c["reduced"]]
    for name in names:
        assert NAME_RE.match(name), name
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [*(c["source"] for c in d["configs"]),
                 *(x["why"] for k in ("configs", "workloads") for x in d[k]),
                 *(m["layer"] for m in d["per_layer"]), *d["command"]]:
        assert 1 <= len(text) <= 200 and not re.search(r"[\n\t]", text)
    for path in d["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", path)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_e2e_and_a_layer(cell):
    c = Manifest(ROOT).cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_a_traffic_mix_is_added_by_files_and_entries_only(tmp_path):
    root = copy_checkout(tmp_path)
    (root / "bench" / "traffic" / "nor8.json").write_text(json.dumps(
        {"driver": "mc_boolean", "op": "nor", "n": 8, "trials": 10000,
         "groups": 9}))
    d = json.loads((root / "BENCHMARK.json").read_text())
    d["workloads"].append({"name": "mc.nor8.b1",
                           "config": "hynix_4gb_m_2666.b1",
                           "traffic": "nor8", "chips": 1, "why": "test"})
    for m in d["end_to_end"]:
        if m["name"] == "call_ms":
            m["workloads"].append("mc.nor8.b1")
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    cell = Manifest(root).cell("mc.nor8.b1")
    assert cell.traffic["op"] == "nor" and cell.config["banks"] == 1
    assert cell.driver == root / "bench" / "drivers" / "mc_boolean.py"
    assert {m["name"] for m in cell.end_to_end} >= {"call_ms", "setup_s"}


def test_a_missing_file_is_refused(tmp_path):
    root = copy_checkout(tmp_path)
    (root / "bench" / "metrics" / "call_ms.py").unlink()
    with pytest.raises(ManifestError, match="call_ms"):
        Manifest(root)
