"""The port's sharded training on 8 CPU processes (``gloo``), a (4, 2)
``("data", "model")`` mesh: the sharded train step against the one-device
step (which ``tests/test_torch_train.py`` holds against the reference's
jitted step), int8 error feedback on the mesh, elastic restore, and the
launcher's preemption and resume.  The reference's own sharded test
(``tests/test_distributed.py``) cannot run here (C-1: its microbatch
reshape of a batch sharded on ``data`` raises ``ShardingTypeError``), so
the port's sharded step is held against the port's one-device step, as
the reference's test meant to hold its own.

All of it runs in one spawn of 8 processes (``_torch_dist_worker.py``,
about 45 s here); each test reads its part of the result.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
#: bf16 compute: the row-parallel products' partial sums round to bf16
#: before the all-reduce, so the loss is held to one bf16 rounding of it
BF16_REL = 2.0 ** -8


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    out = work / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
         str(out), str(work)], env=env, capture_output=True, text=True,
        timeout=400, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", ["dense", "moe", "hybrid", "ssm"])
def test_sharded_step_matches_one_device(results, name):
    """float32 compute: loss within 1e-5, every parameter within 1e-4 (the
    reference test's bound), every gradient within 1e-4 of its leaf's
    largest entry (the bound the card's float32 training check holds
    gradients summed in other orders to).  AdamW's first step moves each
    element by about the learning rate whatever its gradient's size, so
    the parameters alone would not show a wrong gradient."""
    r = results["steps"][name]
    assert r["loss_delta"] <= 1e-5, r
    assert r["param_delta"] <= 1e-4, r
    assert r["grad_rel"] <= 1e-4, r


def test_sharded_step_at_bf16_compute(results):
    """The reference test's config as written (bf16 compute): parameters
    within its 1e-4, the loss within one bf16 rounding, the gradients
    within 2^-4 of each leaf's largest entry (the bound of the port's bf16
    gradient test, ``test_loss_and_grads_at_bf16_compute``)."""
    r = results["steps"]["dense_bf16"]
    assert r["param_delta"] <= 1e-4, r
    assert r["loss_delta"] <= BF16_REL * abs(r["ref_loss"]), r
    assert r["grad_rel"] <= 2.0 ** -4, r


def test_int8_ef_on_the_mesh_is_finite(results):
    r = results["int8_ef"]
    assert r["finite"], r
    assert abs(r["loss"] - r["ref_loss"]) <= BF16_REL * abs(r["ref_loss"])


@pytest.mark.parametrize("target", ["onto_2x4", "placed_on_2x4",
                                    "onto_2x4_shardings", "onto_one"])
def test_elastic_restore_is_bit_equal(results, target):
    """A save on (4, 2) restored onto (2, 4) — by the template's
    placements or by ``shardings=`` — and onto one process."""
    assert results["restore"][target], results["restore"]


def test_launcher_resumes_the_same_trajectory_after_sigterm(results):
    r = results["launcher"]
    assert (r["a_steps"], r["b_steps"], r["c_start"], r["c_steps"],
            r["dp"]) == (3, 1, 1, 3, 8), r
    assert r["a_losses"] == r["bc_losses"], r
    assert r["params_equal"] and r["last_equal"], r
