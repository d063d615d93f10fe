"""``BENCHMARK.json`` and the files it names, found by name.

A cell (one entry of ``workloads``) is resolved into its configuration (the
JSON file its ``configs`` entry names), its traffic mix
(``bench/traffic/<traffic>.json``, whose ``driver`` names
``bench/drivers/<driver>.py``) and the metrics it reports: every
``end_to_end`` and ``per_layer`` metric whose ``workloads`` key lists the
cell, or that has no such key.  Each metric is read by
``bench/metrics/<name>.py``.  A new configuration, traffic mix or metric is
a new file and a new entry; nothing here changes for it.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

#: the benchmark's folder; the manifest sits at the checkout's root above it
BENCH_DIR = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class ManifestError(ValueError):
    """The manifest or a file it names is malformed or missing."""


@dataclass
class Cell:
    """One workload with everything it needs, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    driver: Path
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    #: metric name -> its reader's file
    readers: dict = field(default_factory=dict)


def _check_name(what: str, name) -> None:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ManifestError(f"{what} {name!r}: want 1-64 of letters, digits, "
                            "'_', '.', '-', not starting with '.' or '-'")


def _metrics_for(entries: list, cell: str) -> list:
    return [m for m in entries if "workloads" not in m
            or cell in m["workloads"]]


def load_module(path: Path, name: str):
    """Import one Python file of the benchmark by its path."""
    if not path.is_file():
        raise ManifestError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """The parsed ``BENCHMARK.json`` of one checkout."""

    def __init__(self, root: Path | str | None = None):
        self.root = Path(root) if root is not None else BENCH_DIR.parent
        path = self.root / "BENCHMARK.json"
        try:
            self.data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise ManifestError(f"cannot read {path}: {e}") from e
        self.bench = self.root / self.data["paths"][0]
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.validate()

    def validate(self) -> None:
        """The naming rules, every cross reference, and one file per name."""
        d = self.data
        for c in d["configs"]:
            _check_name("config", c["name"])
            for key in c["reduced"]:
                _check_name("reduced key", key)
            if not (self.root / c["file"]).is_file():
                raise ManifestError(f"config file {c['file']} is missing")
        metrics = d["end_to_end"] + d["per_layer"]
        for m in metrics:
            _check_name("metric", m["name"])
            if not UNIT_RE.match(m["unit"]):
                raise ManifestError(f"unit {m['unit']!r} of {m['name']}")
            if m["better"] not in ("lower", "higher"):
                raise ManifestError(f"{m['name']}: better={m['better']!r}")
            for w in m.get("workloads", ()):
                if w not in self.workloads:
                    raise ManifestError(f"{m['name']} lists unknown cell {w}")
            self.reader(m["name"])
        for kind in ("configs", "workloads"):
            names = [x["name"] for x in d[kind]]
            if len(set(names)) != len(names):
                raise ManifestError(f"duplicate names in {kind}")
        if len({m["name"] for m in metrics}) != len(metrics):
            raise ManifestError("duplicate metric names")
        pairs = set()
        for w in d["workloads"]:
            for key in ("name", "config", "traffic"):
                _check_name(f"workload {key}", w[key])
            if w["config"] not in self.configs:
                raise ManifestError(f"{w['name']}: unknown config")
            if (w["config"], w["traffic"]) in pairs:
                raise ManifestError(f"{w['name']}: pair used twice")
            pairs.add((w["config"], w["traffic"]))
            self.traffic(w["traffic"])

    def traffic(self, name: str) -> dict:
        path = self.bench / "traffic" / f"{name}.json"
        if not path.is_file():
            raise ManifestError(f"traffic mix {name}: missing {path}")
        mix = json.loads(path.read_text())
        self.driver_path(mix["driver"])
        return mix

    def driver_path(self, driver: str) -> Path:
        _check_name("driver", driver)
        path = self.bench / "drivers" / f"{driver}.py"
        if not path.is_file():
            raise ManifestError(f"driver {driver}: missing {path}")
        return path

    def reader(self, metric: str) -> Path:
        path = self.bench / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise ManifestError(f"metric {metric}: missing reader {path}")
        return path

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise ManifestError(f"unknown workload {name!r}; known: "
                                f"{sorted(self.workloads)}")
        w = self.workloads[name]
        cfg_entry = self.configs[w["config"]]
        config = json.loads((self.root / cfg_entry["file"]).read_text())
        e2e = _metrics_for(self.data["end_to_end"], name)
        per_layer = _metrics_for(self.data["per_layer"], name)
        mix = self.traffic(w["traffic"])
        return Cell(name=name, chips=int(w["chips"]), config=config,
                    traffic=mix, driver=self.driver_path(mix["driver"]),
                    end_to_end=e2e, per_layer=per_layer,
                    readers={m["name"]: self.reader(m["name"])
                             for m in e2e + per_layer})
