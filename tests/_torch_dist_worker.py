"""Worker of ``tests/test_torch_distributed.py``: 8 ``gloo`` processes on
the CPU, a (4, 2) ``("data", "model")`` mesh.

    python tests/_torch_dist_worker.py OUT.json WORKDIR

Rank 0 writes one JSON object of results to OUT.json:

* ``steps``: per config, the sharded train step against the one-device
  step on the same state and batch (the gradients' largest |diff| over
  each leaf's largest entry, loss |diff|, the largest parameter |diff|);
* ``int8_ef``: the sharded step with int8 error feedback (loss, finite);
* ``restore``: a save on (4, 2) restored onto (2, 4) (from the template's
  placements and from ``shardings=``) and onto one process, each leaf
  compared bit for bit;
* ``launcher``: ``launch.train.main`` on the (8, 1) host mesh, run
  uninterrupted and run with SIGTERM after its first step then resumed.
"""
import json
import os
import signal
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 8


def _configs():
    from repro_torch.configs import get_config
    from repro_torch.models.config import ModelConfig
    # the reference test's config (tests/test_distributed.py), at float32
    # compute (the port's parity mode) and at its own bf16 compute
    ref = ModelConfig("t", 2, 64, 4, 2, 128, 256, head_dim=16)
    return {
        "dense": ref.replace(compute_dtype="float32"),
        "dense_bf16": ref,
        "moe": get_config("qwen2-moe-a2.7b").smoke(),
        "hybrid": get_config("hymba-1.5b").smoke(),
        "ssm": get_config("mamba2-780m").smoke(),
    }


def _batch() -> dict:
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 256, (8, 32)).astype(np.int32),
            "labels": rng.integers(0, 256, (8, 32)).astype(np.int32)}


def _placed_batch(batch, mesh):
    from repro_torch.launch.sharding import batch_specs, distribute_tree
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return distribute_tree(tb, batch_specs(tb, mesh), mesh)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _steps(mesh) -> dict:
    """Sharded step vs one-device step per config (2 microbatches), and
    the gradients it applies (before compression, clipping and AdamW,
    whose first step moves every element by about the learning rate
    whatever its gradient's size)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.sharding import distribute_tree, state_specs
    from repro_torch.models.config import TrainConfig
    from repro_torch.train import optim as O
    from repro_torch.train import step as TS
    out = {}
    batch = _batch()
    for name, cfg in _configs().items():
        tc = TrainConfig(learning_rate=1e-3, n_microbatches=2)
        ref = TS.init_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
        state = TS.init_state(torch.Generator().manual_seed(0), cfg, tc,
                              "cpu")
        step = TS.build_train_step(cfg, tc)
        g_ref, _m = TS.accumulate_grads(ref["params"], cfg, tc, batch)
        ref, rm = step(ref, batch)
        t0 = time.time()
        st = distribute_tree(state, state_specs(cfg, state, mesh), mesh)
        with implicit_replication():
            g_sh, _m = TS.accumulate_grads(st["params"], cfg, tc,
                                           _placed_batch(batch, mesh))
        st, m = step(st, _placed_batch(batch, mesh))
        out[name] = {
            "grad_rel": max(
                float((_full(a) - b).abs().max())
                / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g_sh, g_ref, strict=True)),
            "loss": float(m["loss"]), "ref_loss": float(rm["loss"]),
            "loss_delta": abs(float(m["loss"]) - float(rm["loss"])),
            "param_delta": max(
                float((_full(a) - b).abs().max()) for a, b in zip(
                    O.tree_leaves(st["params"]),
                    O.tree_leaves(ref["params"]), strict=True)),
            "sharded_s": time.time() - t0}
    return out


def _int8(mesh) -> dict:
    from repro_torch.launch.sharding import distribute_tree, state_specs
    from repro_torch.models.config import TrainConfig
    from repro_torch.train import step as TS
    cfg = _configs()["dense_bf16"]
    tc = TrainConfig(learning_rate=1e-3, grad_compression="int8_ef")
    state = TS.init_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
    ref = TS.init_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
    step = TS.build_train_step(cfg, tc)
    _r, rm = step(ref, _batch())
    st = distribute_tree(state, state_specs(cfg, state, mesh), mesh)
    _s, m = step(st, _placed_batch(_batch(), mesh))
    return {"loss": float(m["loss"]), "ref_loss": float(rm["loss"]),
            "finite": bool(np.isfinite(float(m["loss"]))
                           and np.isfinite(float(m["grad_norm"])))}


def _restore(mesh, workdir: str) -> dict:
    """Save a stepped state on (4, 2); restore it onto (2, 4) and onto one
    process; -> whether every leaf came back bit-equal."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (distribute_tree, leaf_paths,
                                             map_paths, state_specs,
                                             to_placements)
    from repro_torch.models.config import TrainConfig
    from repro_torch.train import step as TS
    cfg = _configs()["dense"]
    tc = TrainConfig(learning_rate=1e-3)
    fresh = lambda: TS.init_state(torch.Generator().manual_seed(1),  # noqa
                                  cfg, tc, "cpu")
    state = TS.init_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
    st = distribute_tree(state, state_specs(cfg, state, mesh), mesh)
    st, _m = TS.build_train_step(cfg, tc)(st, _placed_batch(_batch(), mesh))
    want = {p: _full(t) for p, t in leaf_paths(st)}
    cm = CheckpointManager(os.path.join(workdir, "ckpt"))
    cm.save(1, st, extra={"note": "4x2"})
    mesh24 = make_host_mesh(model=4, device="cpu")
    tmpl = fresh()
    specs = state_specs(cfg, tmpl, mesh24)
    at, got = cm.restore(distribute_tree(tmpl, specs, mesh24))
    placed_ok = all(t.device_mesh is mesh24 for _p, t in leaf_paths(got))
    eq24 = at == 1 and all(
        torch.equal(_full(t), want[p]) and _full(t).dtype == want[p].dtype
        for p, t in leaf_paths(got))
    spec_at = dict(leaf_paths(specs))
    shardings = map_paths(
        lambda p, _t: (mesh24, to_placements(spec_at[p], mesh24)), tmpl)
    _at, got2 = cm.restore(fresh(), shardings=shardings)
    eq24_shardings = all(torch.equal(_full(t), want[p])
                         for p, t in leaf_paths(got2))
    _at, one = cm.restore(fresh())
    eq1 = all(not hasattr(t, "device_mesh") and torch.equal(t, want[p])
              for p, t in leaf_paths(one))
    return {"onto_2x4": eq24, "placed_on_2x4": placed_ok,
            "onto_2x4_shardings": eq24_shardings, "onto_one": eq1}


def _launcher(workdir: str) -> dict:
    """``launch.train.main`` on the host mesh: 3 steps uninterrupted; then
    SIGTERM in the first step (rank 0 only: the ranks agree), a final
    checkpoint, and a restart that runs steps 1-2."""
    from repro_torch.launch import train as LT
    from repro_torch.train import optim as O
    from repro_torch.train import step as TS
    args = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--steps",
            "3", "--batch", "8", "--seq", "32", "--ckpt-every", "100"]
    a = LT.main(args + ["--out", os.path.join(workdir, "a")])
    build = TS.build_train_step

    def interrupted(cfg, tc):
        step = build(cfg, tc)
        calls = []

        def first_step_preempted(state, batch):
            calls.append(1)
            if len(calls) == 1 and dist.get_rank() == 0:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(state, batch)

        return first_step_preempted

    TS.build_train_step = interrupted
    try:
        b = LT.main(args + ["--out", os.path.join(workdir, "b")])
    finally:
        TS.build_train_step = build
    c = LT.main(args + ["--out", os.path.join(workdir, "b")])
    out = {"a_steps": a["steps"], "b_steps": b["steps"],
           "c_start": c["start"], "c_steps": c["steps"], "dp": c["dp"],
           "params_equal": all(
               torch.equal(_full(x), _full(y)) for x, y in zip(
                   O.tree_leaves(a["state"]["params"]),
                   O.tree_leaves(c["state"]["params"]), strict=True)),
           "last_equal": a["last"]["loss"] == c["last"]["loss"]}
    if dist.get_rank() == 0:
        def losses(d):
            with open(os.path.join(workdir, d, "metrics.jsonl")) as f:
                return [json.loads(line)["loss"] for line in f]
        out["a_losses"], out["bc_losses"] = losses("a"), losses("b")
    return out


def worker(rank: int, out_path: str, workdir: str, port: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=2, device="cpu")
        t0 = time.time()
        res = {"steps": _steps(mesh), "int8_ef": _int8(mesh),
               "restore": _restore(mesh, workdir),
               "launcher": _launcher(workdir)}
        res["seconds"] = time.time() - t0
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    out_path, workdir = sys.argv[1], sys.argv[2]
    mp.start_processes(worker, args=(out_path, workdir, _free_port()),
                       nprocs=WORLD, start_method="spawn")
