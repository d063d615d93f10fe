"""What a run may load and where it may run: no JAX and no JAX package in
its process, a reference that imports nothing of the program, no result
without the program or without the card."""
import json
import subprocess
import sys

import pytest

from bench import harness
from bench.conftest import CASES, ROOT, add_toy, copy_checkout, small_copy
from bench.manifest import Manifest


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core.charz", "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(
        ["repro_torch", "repro.core", "jax._src", "flax"]) == \
        ["flax", "jax", "repro"]


@pytest.mark.parametrize("toy", [False, True], ids=["repo", "toy"])
def test_a_run_of_every_cell_loads_neither_jax_nor_repro(tmp_path, toy):
    root = small_copy(tmp_path, toy)
    code = f"""
import io, json, sys
sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from bench import harness
from bench.manifest import Manifest
m = Manifest({str(root)!r})
ok = [harness.run_cell(m.cell(w), 5, 0.1, t, device="cpu",
                       log=io.StringIO())["correct"]
      for w in m.workloads for t in (False, True)]
print(json.dumps({{"ok": ok, "bad": harness.forbidden_modules(),
                  "top": sorted({{n.split(".")[0] for n in sys.modules}})}}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert all(got["ok"])
    assert len(got["ok"]) == 2 * len(Manifest(root).workloads)
    assert got["bad"] == []
    assert "repro_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["top"])


def test_the_reference_imports_nothing_of_the_program():
    code = f"""
import json, sys
sys.path[0:0] = [{str(ROOT)!r}]
import bench.reference.mc, bench.reference.model
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & top


@pytest.mark.parametrize("toy, name", CASES)
def test_no_result_without_the_program_or_the_card(tmp_path, toy, name):
    """A folder holding only the manifest and the benchmark: no result, a
    non-zero exit (here: no card; on a card: no ``repro_torch``)."""
    root = copy_checkout(tmp_path)
    if toy:
        add_toy(root)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(Manifest(ROOT).workloads))
def test_a_short_run_on_the_card_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name,
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
