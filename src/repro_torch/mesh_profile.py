"""The sharded train step across cards, held against the one-device step,
and the training launcher across cards.

    torchrun --nproc-per-node 4 -m repro_torch.mesh_profile \\
        [--model 2] [--out build/mesh_profile.json]

Every rank joins the group ``torchrun`` describes (NCCL on the card) and
builds the host mesh ``(world / model, model)`` ``("data", "model")``.

1. ``parity``: qwen3-4b's widths cut to ``LAYERS`` layers, float32, TF32
   off: one train step of ``BATCH x SEQ`` tokens in 2 microbatches on
   DTensors placed by ``launch/sharding.py``, against the same step on the
   rank's own card without a mesh, from the same seed: the loss, the
   global norm and the parameters' largest difference; the attention
   kernels' launches of each and the head count the sharded step's kernel
   saw (the ``model`` axis splits qwen3-4b's 32 / 8 heads); both walls.
2. ``launcher``: hymba-1.5b uncut through ``launch.train.main`` on the
   ``(world, 1)`` host mesh (data parallel): ``STEPS`` steps of ``world x
   2 x 2048`` tokens; step walls, tokens/s, peak bytes.

Rank 0 prints one JSON object and writes it to ``--out``.  ``--device
cpu --smoke`` runs both at the smoke configs on ``gloo`` (a rehearsal of
the flow; the CPU has no kernel to count).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

LAYERS, BATCH, SEQ, STEPS = 4, 4, 2048, 3
LAUNCH_ARCH = "hymba-1.5b"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _parity(args, mesh, dev: torch.device) -> dict:
    from .configs import get_config
    from .data.pipeline import DataConfig, SyntheticLM
    from .kernels import flash_attention as FA
    from .launch.sharding import (batch_specs, distribute_tree,
                                  state_specs)
    from .models.config import TrainConfig
    from .train import optim as TO
    from .train import step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-4b")
    cfg = cfg.smoke() if args.smoke else cfg.replace(
        n_layers=LAYERS, param_dtype="float32", compute_dtype="float32")
    seq = 32 if args.smoke else SEQ
    tc = TrainConfig(learning_rate=1e-3, n_microbatches=2)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=BATCH),
                        device="cpu").batch(0)
    step = TS.build_train_step(cfg, tc)

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(7)
        return TS.init_state(gen, cfg, tc, dev)

    heads = []
    kernel = FA.flash_attention_cuda

    def seen(q, *a, **k):
        heads.append(int(q.shape[2]))
        return kernel(q, *a, **k)

    FA.flash_attention_cuda = seen
    try:
        before = dict(FA.launches)
        _sync(dev)
        t0 = time.perf_counter()
        plain, pm = step(fresh(), batch)
        _sync(dev)
        plain_s = time.perf_counter() - t0
        mid = dict(FA.launches)
        plain_heads, heads[:] = list(heads), []
        state = fresh()
        state = distribute_tree(state, state_specs(cfg, state, mesh), mesh)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        tb = distribute_tree(tb, batch_specs(tb, mesh), mesh)
        dist.barrier()
        t0 = time.perf_counter()
        sharded, sm = step(state, tb)
        _sync(dev)
        sharded_s = time.perf_counter() - t0
        after = dict(FA.launches)
    finally:
        FA.flash_attention_cuda = kernel
    got = TO.tree_leaves(sharded["params"])
    want = TO.leaves_like(plain["params"], sharded["params"])
    diffs = [float((x.full_tensor() - y).abs().max())
             for x, y in zip(got, want, strict=True)]
    over = sum(int(((x.full_tensor() - y).abs() > 1e-5).sum())
               for x, y in zip(got, want, strict=True))
    return {
        "layers": cfg.n_layers, "batch": BATCH, "seq": seq,
        "loss": [float(pm["loss"]), float(sm["loss"])],
        "loss_rel": abs(float(pm["loss"]) - float(sm["loss"]))
        / abs(float(pm["loss"])),
        "grad_norm": [float(pm["grad_norm"]), float(sm["grad_norm"])],
        "param_max_abs_diff": max(diffs), "params_over_1e-5": over,
        "launches_plain": {k: mid[k] - before[k] for k in mid},
        "launches_sharded": {k: after[k] - mid[k] for k in after},
        "kernel_heads_plain": sorted(set(plain_heads)),
        "kernel_heads_sharded": sorted(set(heads)),
        "plain_step_s": plain_s, "sharded_step_s": sharded_s}


def _launcher(args, world: int) -> dict:
    from .launch import train as LT
    arch_args = ["--smoke"] if args.smoke else []
    batch = world * 2
    seq = 32 if args.smoke else SEQ
    path = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(path, src=0)     # one directory: rank 0's
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        res = LT.main(["--arch", LAUNCH_ARCH, *arch_args, "--steps",
                       str(STEPS), "--batch", str(batch), "--seq", str(seq),
                       "--ckpt-every", "100", "--device", args.device,
                       "--out", path[0]])
        recs = []
        if dist.get_rank() == 0:
            with open(os.path.join(path[0], "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
        dist.barrier()
    finally:
        if dist.get_rank() == 0:
            shutil.rmtree(path[0], ignore_errors=True)
    walls = [r["dt_s"] for r in recs]
    return {"arch": LAUNCH_ARCH, "dp": res["dp"], "batch": batch,
            "seq": seq, "step_wall_s": walls,
            "tokens_per_s": [batch * seq / w for w in walls],
            "loss": [r["loss"] for r in recs],
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if args.device == "cuda" else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="build/mesh_profile.json")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mesh_profile: no CUDA device", file=sys.stderr)
        return 1
    from .launch.mesh import make_host_mesh
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        world = dist.get_world_size()
        mesh = make_host_mesh(model=args.model, device=dev.type)
        out = {"world": world, "mesh": [world // args.model, args.model],
               "parity": _parity(args, mesh, dev),
               "launcher": _launcher(args, world)}
        if args.device == "cuda":
            out["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
        if dist.get_rank() == 0:
            text = json.dumps(out, indent=1)
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(text)
            print(text)
        assert np.isfinite(out["parity"]["loss"]).all()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
