"""The port's checkpoints and training launcher (the reference's
tests/test_ckpt_serve.py checkpoint half, on the port's state).

``CheckpointManager`` round-trips a train state bit for bit (bf16 leaves
included, stored as their int16 bits), writes asynchronously, keeps the
newest N, leaves no ``.tmp`` behind, raises ``ValueError`` on a shape
mismatch and ``KeyError`` on a missing leaf; a state restored mid-run and
stepped on gives exactly the uninterrupted trajectory.  The launcher runs
in process on the CPU (``--smoke --device cpu``), resumes from its last
checkpoint, and ends where one uninterrupted run ends.  Port only: no jax.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as TL
from repro_torch.models.config import ModelConfig, TrainConfig
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

CFG = ModelConfig("t", 2, 64, 4, 2, 128, 256, head_dim=16,
                  compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager tensors: one intra-op thread each, so parallel test
    workers do not oversubscribe the CPU (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(cfg=CFG, tc=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return TS.init_state(gen, cfg, tc or TrainConfig(), "cpu")


def _equal(a, b) -> bool:
    la, lb = TO.tree_leaves(a), TO.leaves_like(b, a)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    state = _state(tc=TrainConfig(grad_compression="int8_ef"))
    cm.save(7, state)
    tmpl = TO.tree_map(torch.zeros_like, state)
    step, restored = cm.restore(tmpl)
    assert step == 7 and _equal(state, restored)
    names = cm.manifest(7)["leaves"]
    assert "params/blocks/1/attn/wq" in names and "opt/count" in names
    assert names["step"]["dtype"] == "int32"


def test_bf16_leaves_roundtrip_as_their_bits(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(1))
    state = {"w": x.to(torch.bfloat16), "f": x, "i": torch.arange(3)}
    cm.save(1, state)
    meta = cm.manifest(1)["leaves"]["w"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [5, 7]
    with np.load(os.path.join(tmp_path, "step_0000000001",
                              "arrays.npz")) as data:
        assert data["w"].dtype == np.int16
    _, back = cm.restore(TO.tree_map(torch.zeros_like, state))
    assert _equal(state, back)


def test_async_save(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    state = _state()
    cm.save_async(3, state)
    cm.wait()
    assert cm.latest_step() == 3
    _, back = cm.restore(state)
    assert _equal(state, back)


def test_async_save_snapshots_before_returning(tmp_path):
    """The host copy is taken in ``save_async``: changing the state after
    it returns does not change what is written."""
    cm = CheckpointManager(str(tmp_path))
    state = {"x": torch.ones(4)}
    cm.save_async(1, state)
    state["x"].add_(1)
    cm.wait()
    _, back = cm.restore(state)
    assert torch.equal(back["x"], torch.ones(4))


def test_gc_keeps_last_n(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    state = {"x": torch.ones(4)}
    for s in (1, 2, 3, 4):
        cm.save(s, state)
    assert cm.all_steps() == [3, 4]


def test_atomicity_no_tmp_left(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"x": torch.ones(4)})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    # a stale staging directory (a writer that died) is not a checkpoint
    os.makedirs(os.path.join(tmp_path, "step_0000000009.tmp"))
    assert cm.latest_step() == 1


def test_restore_rejects_shape_mismatch(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"x": torch.ones(4)})
    with pytest.raises(ValueError):
        cm.restore({"x": torch.ones(5)})


def test_restore_missing_leaf(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"x": torch.ones(4)})
    with pytest.raises(KeyError):
        cm.restore({"y": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"x": 0})


@pytest.mark.parametrize("opt,comp", [("adamw", "none"),
                                      ("adafactor", "int8_ef")])
def test_restore_resumes_the_same_trajectory(tmp_path, opt, comp):
    """Save after step 3, restore into a fresh state, step on: the state
    after step 5 equals the uninterrupted run's bit for bit."""
    cfg = CFG.replace(optimizer=opt)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20,
                     n_microbatches=2, grad_compression=comp)
    data = SyntheticLM(DataConfig(vocab=256, seq_len=32, global_batch=4),
                       device="cpu")
    step_fn = TS.build_train_step(cfg, tc)
    state = _state(cfg, tc)
    cm = CheckpointManager(str(tmp_path))
    for i in range(5):
        state, _m = step_fn(state, data.batch(i))
        if i == 2:
            cm.save(3, state)
    step, again = cm.restore(_state(cfg, tc, seed=9))
    assert step == 3 and int(again["step"]) == 3
    for i in range(3, 5):
        again, _m = step_fn(again, data.batch(i))
    assert _equal(state, again)


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    """--smoke --device cpu: 3 steps, then a resumed run to 5, equal to
    one run of 5 steps; the last line says the run was on one device."""
    common = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
              "--batch", "4", "--seq", "32", "--ckpt-every", "2"]
    a = str(tmp_path / "a")
    first = TL.main([*common, "--steps", "3", "--out", a])
    assert first["steps"] == 3 and first["start"] == 0
    assert CheckpointManager(a).all_steps() == [2, 3]
    resumed = TL.main([*common, "--steps", "5", "--out", a])
    assert resumed["start"] == 3 and resumed["steps"] == 5
    out = capsys.readouterr().out.strip().splitlines()
    assert "resumed from step 3" in "\n".join(out)
    assert out[-1].startswith("[train] done: 5 steps, dp=1")
    whole = TL.main([*common, "--steps", "5", "--out", str(tmp_path / "b")])
    assert _equal(whole["state"], resumed["state"])
    with open(os.path.join(a, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [0, 1, 2, 3, 4]
    assert np.isfinite(resumed["last"]["loss"])


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1", "--out",
                 "/nonexistent/never-written"])
