"""The manifest: it parses, keeps the naming rules and the contract's rules
on cells, and grows by files."""
import json
import re

import pytest

from bench.conftest import (CASES, ROOT, cells_of_kind, copy_checkout,
                            small_copy)
from bench.manifest import NAME_RE, UNIT_RE, Manifest, ManifestError
from bench.mcjudge import McDriver


def test_manifest_parses_with_the_contract_keys():
    m = Manifest(ROOT)
    assert set(m.data) == {"command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"}
    assert m.data["command"] == ["python3", "bench/run.py"]
    assert m.data["paths"] == ["bench"]
    for e in m.data["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert {e["name"] for e in m.data["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("toy", [False, True], ids=["repo", "toy"])
def test_the_cells_keep_the_contracts_rules(tmp_path, toy):
    """1 to 24 cells on 1 or 4 chips, at most a quarter of them (one at
    least) on 4, and every configuration used by a cell."""
    m = Manifest(small_copy(tmp_path, toy) if toy else ROOT)
    n = len(m.workloads)
    assert 1 <= n <= 24
    chips = [w["chips"] for w in m.workloads.values()]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, n // 4)
    assert set(m.configs) == {w["config"] for w in m.workloads.values()}


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


@pytest.mark.parametrize("toy, cell", CASES)
def test_every_cell_reports_setup_another_e2e_and_a_layer(tmp_path, toy,
                                                          cell):
    c = Manifest(small_copy(tmp_path, toy) if toy else ROOT).cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_a_traffic_mix_is_added_by_files_and_entries_only(tmp_path):
    """A new MC mix on the configuration of an MC cell."""
    root = copy_checkout(tmp_path)
    m = Manifest(root)
    config = m.workloads[cells_of_kind(McDriver)[0]]["config"]
    (root / "bench" / "traffic" / "nor8.json").write_text(json.dumps(
        {"driver": "mc_boolean", "op": "nor", "n": 8, "trials": 10000,
         "groups": 9}))
    d = json.loads((root / "BENCHMARK.json").read_text())
    d["workloads"].append({"name": "mc.nor8", "config": config,
                           "traffic": "nor8", "chips": 1, "why": "test"})
    for e in d["end_to_end"]:
        if e["name"] == "call_ms":
            e["workloads"].append("mc.nor8")
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    cell = Manifest(root).cell("mc.nor8")
    assert cell.traffic["op"] == "nor"
    assert cell.config == json.loads(
        (root / m.configs[config]["file"]).read_text())
    assert cell.driver == root / "bench" / "drivers" / "mc_boolean.py"
    assert {e["name"] for e in cell.end_to_end} >= {"call_ms", "setup_s"}


def test_a_cell_of_a_second_kind_is_added_by_files_and_entries_only(
        tmp_path):
    """The toy kind: a configuration with no ``module``, its own mix,
    driver and per-layer reader, one ``workloads`` entry, and its name in
    ``call_ms``; every file that was there is unchanged."""
    from bench.conftest import TOY_CELL, add_toy
    root = copy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    add_toy(root)
    assert all(p.read_bytes() == b for p, b in before.items())
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((root / "BENCHMARK.json").read_text())
    assert new["workloads"][:-1] == old["workloads"]
    cell = Manifest(root).cell(TOY_CELL)
    assert "module" not in cell.config
    assert cell.driver.parent == root / "bench" / "drivers"
    assert {e["name"] for e in cell.end_to_end} == {"call_ms", "peak_mem_GiB",
                                                    "setup_s"}


def test_a_config_that_two_drivers_cut_differently_is_refused(tmp_path):
    """The toy's mix on an MC configuration: the toy's ``small`` and the MC
    drivers' cut that file to different sizes."""
    from bench.conftest import TOY_CELL, add_toy, cut_to_small
    root = add_toy(copy_checkout(tmp_path))
    d = json.loads((root / "BENCHMARK.json").read_text())
    toy = next(w for w in d["workloads"] if w["name"] == TOY_CELL)
    toy["config"] = d["workloads"][0]["config"]
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    with pytest.raises(ValueError, match="different sizes"):
        cut_to_small(root)


def test_a_missing_file_is_refused(tmp_path):
    root = copy_checkout(tmp_path)
    (root / "bench" / "metrics" / "call_ms.py").unlink()
    with pytest.raises(ManifestError, match="call_ms"):
        Manifest(root)
