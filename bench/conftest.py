"""Fixtures of the benchmark's own tests (``python -m pytest bench``).

They run on the CPU at small sizes; a test that needs the card carries the
``cuda`` marker and skips where ``torch.cuda.is_available()`` is false.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

#: the CPU tests' sizes: rows of 256 bits, 96 trials a bank (480 on 16 banks)
SMALL_ROW_BITS = 256


def small_trials(mix: dict) -> int:
    return 480 if mix["groups"] > 9 else 96


def copy_checkout(dest: Path) -> Path:
    """``BENCHMARK.json`` and the benchmark's folder, copied to ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


@pytest.fixture
def small_checkout(tmp_path) -> Path:
    """A copy of the benchmark with every configuration's rows cut to
    ``SMALL_ROW_BITS`` and every mix's trials to :func:`small_trials`."""
    root = copy_checkout(tmp_path)
    for f in (root / "bench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["module"]["row_bits"] = SMALL_ROW_BITS
        f.write_text(json.dumps(cfg))
    for f in (root / "bench" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix["trials"] = small_trials(mix)
        f.write_text(json.dumps(mix))
    return root


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
