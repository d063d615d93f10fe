"""Fixtures of the benchmark's own tests (``python -m pytest bench``).

They run on the CPU at small sizes, each cell cut by its own driver's
``small`` (``bench/drivers/__init__.py``); a test that needs the card
carries the ``cuda`` marker and skips where ``torch.cuda.is_available()``
is false.  The generic tests take their cells from the manifest
(:data:`CASES`), and also run on a copy of the checkout to which the toy
kind of ``bench/fixtures/toy`` is added by files and entries alone.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from bench.manifest import Manifest, load_module  # noqa: E402

#: a traffic kind unlike the MC, with its entries (``entries.json``)
TOY = ROOT / "bench" / "fixtures" / "toy"
_TOY_ENTRIES = json.loads((TOY / "entries.json").read_text())
#: the toy kind's cell, added to a copy of the checkout by :func:`add_toy`
TOY_CELL = _TOY_ENTRIES["workloads"][0]["name"]


def copy_checkout(dest: Path) -> Path:
    """``BENCHMARK.json`` and the benchmark's folder, copied to ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def add_toy(root: Path) -> Path:
    """Add the toy kind's cell to the checkout at ``root`` by files and
    entries only: its files into ``bench/``, its ``configs``, ``workloads``
    and ``per_layer`` entries, and its name in the ``workloads`` of the
    end-to-end metrics that ``entries.json`` lists."""
    for sub in ("configs", "drivers", "metrics", "traffic"):
        shutil.copytree(TOY / sub, root / "bench" / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    d = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        d[key] += _TOY_ENTRIES[key]
    for m in d["end_to_end"]:
        if m["name"] in _TOY_ENTRIES["listed_in"]:
            m["workloads"] += [w["name"] for w in _TOY_ENTRIES["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(d, indent=1))
    return root


def driver_of(cell):
    """The ``DRIVER`` of a cell's traffic kind, loaded anew."""
    return load_module(cell.driver, cell.traffic["driver"]).DRIVER


def cut_to_small(root: Path) -> Path:
    """Every configuration and mix that the cells at ``root`` use, cut in
    place to the ``small`` sizes of their cells' drivers.  A file that two
    cells' drivers cut differently is refused."""
    m = Manifest(root)
    cut: dict[Path, dict] = {}
    for name, w in m.workloads.items():
        cell = m.cell(name)
        cfg, mix = driver_of(cell).small(cell.config, cell.traffic)
        for path, data in ((root / m.configs[w["config"]]["file"], cfg),
                           (m.bench / "traffic" / f"{w['traffic']}.json",
                            mix)):
            if cut.setdefault(path, data) != data:
                raise ValueError(f"{path}: the drivers of its cells cut it "
                                 "to different sizes")
    for path, data in cut.items():
        path.write_text(json.dumps(data))
    return root


def small_copy(dest: Path, toy: bool = False) -> Path:
    """A copy of the benchmark at ``dest``, with the toy kind's cell added
    where ``toy``, cut to the drivers' small sizes."""
    root = copy_checkout(dest)
    if toy:
        add_toy(root)
    return cut_to_small(root)


def _cases() -> list:
    """``(toy, cell, driver)``: every cell of the manifest, then the toy
    cell (of the copy with the toy kind added)."""
    m = Manifest(ROOT)
    out = [(False, name, driver_of(m.cell(name))) for name in m.workloads]
    traffic = _TOY_ENTRIES["workloads"][0]["traffic"]
    kind = json.loads((TOY / "traffic" / f"{traffic}.json").read_text())[
        "driver"]
    toy = load_module(TOY / "drivers" / f"{kind}.py", kind).DRIVER
    return out + [(True, TOY_CELL, toy)]


_CASES = _cases()
#: the generic tests' cases: ``(toy, cell)``
CASES = [pytest.param(toy, name, id=name) for toy, name, _d in _CASES]
#: ``(toy, cell, fault name)`` for every fault of every cell's driver
FAULT_CASES = [pytest.param(toy, name, f.__name__, id=f"{name}-{f.__name__}")
               for toy, name, d in _CASES for f in d.faults]


def cells_of_kind(kind: type) -> list[str]:
    """The manifest's cells whose driver is a ``kind``."""
    return [name for toy, name, d in _CASES
            if not toy and isinstance(d, kind)]


@pytest.fixture
def small_checkout(tmp_path) -> Path:
    """A copy of the benchmark cut to its drivers' small sizes."""
    return small_copy(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
