"""Training launcher of the port: the train loop with sharding,
checkpoints, resume, preemption and straggler accounting (the port of
``repro.launch.train``).

* sharded state + batch: started under ``torchrun`` (or inside an
  initialised default process group) it builds the host mesh ``(world,
  1)`` ``("data", "model")`` over every rank, places the state by
  ``state_specs`` and each batch by ``batch_specs`` (the dry-run's rules)
  and steps on DTensors; without a group it runs one device as before;
* periodic async checkpoints + automatic resume from the latest one (a
  restart continues the same trajectory: the data stream is a function of
  the step); on a mesh rank 0 writes the gathered state and every rank
  restores it onto its own placements;
* preemption: SIGTERM sets a flag, the ranks agree on it after each step
  (an all-reduce of the flag), write a final checkpoint and exit cleanly;
* per-step deadline straggler detection (logged and counted).

Every rank draws the whole global batch and keeps its rows when it is
placed: the reference's docstring promises host-sharded loading, its code
draws the global batch (ROADMAP C-11).

Usage (on the card; ``--device cpu`` runs the plain kernels on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --device cpu --steps 20 --out /tmp/t
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch qwen3-4b --steps 200 --batch 16 --seq 2048 --out /tmp/t
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import torch
import torch.distributed as dist

from ..ckpt.checkpoint import CheckpointManager
from ..configs import get_config
from ..core.simulator import resolve_device
from ..data.pipeline import DataConfig, SyntheticLM
from ..models.config import TrainConfig
from ..train import step as TS
from .mesh import dp_size, make_host_mesh
from .sharding import batch_specs, distribute_tree, state_specs


def _open_group(device: torch.device) -> bool:
    """Join the default process group ``torchrun`` describes (its
    environment), unless one is open; -> whether a group is open.  On the
    card each rank takes its ``LOCAL_RANK``'s device."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if dist.is_initialized() and device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    return dist.is_initialized()


def _agree(flag: bool, device: torch.device) -> bool:
    """Whether any rank raised ``flag`` (each rank's own without a
    group)."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--out", default="/tmp/fcdram_train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--step-deadline-s", type=float, default=0.0,
                    help=">0: log steps exceeding the deadline (straggler "
                         "mitigation hook)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 20, 5),
                     n_microbatches=args.microbatches,
                     grad_compression=args.compression,
                     checkpoint_every=args.ckpt_every)
    dev = resolve_device(args.device)
    mesh = (make_host_mesh(device=dev.type) if _open_group(dev) else None)
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    lead = not dist.is_initialized() or dist.get_rank() == 0
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=tc.seed,
                                  dedup=True), device=dev)
    step_fn = TS.build_train_step(cfg, tc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(tc.seed)
    state = TS.init_state(gen, cfg, tc, dev)
    if mesh is not None:
        state = distribute_tree(state, state_specs(cfg, state, mesh), mesh)

    def batch_at(step: int) -> dict:
        b = data.batch(step)
        if mesh is None:
            return b
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        return distribute_tree(b, batch_specs(b, mesh), mesh,
                               src_data_rank=None)

    cm = CheckpointManager(args.out, keep=tc.keep_checkpoints)
    start = 0
    if cm.latest_step() is not None:
        start, state = cm.restore(state)
        data.load_state_dict(cm.manifest(start)["extra"])
        if lead:
            print(f"[train] resumed from step {start}")

    stop = {"flag": False}

    def on_term(_sig, _frm):
        print("[train] preemption signal: checkpoint + exit")
        stop["flag"] = True

    prev = signal.signal(signal.SIGTERM, on_term)
    log_path = os.path.join(args.out, "metrics.jsonl")
    stragglers, done, saved, last = 0, start, start, {}
    try:
        with open(log_path, "a") if lead else open(os.devnull, "w") as logf:
            for step in range(start, args.steps):
                t0 = time.time()
                state, metrics = step_fn(state, batch_at(step))
                rec = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                if args.step_deadline_s and dt > args.step_deadline_s:
                    stragglers += 1
                    print(f"[train] straggler: step {step} took {dt:.2f}s")
                last = {"step": step, "dt_s": round(dt, 4), **rec}
                logf.write(json.dumps(last) + "\n")
                if step % 10 == 0 and lead:
                    print(f"[train] step {step} loss {rec['loss']:.4f} "
                          f"acc {rec['accuracy']:.3f} {dt:.2f}s")
                done = step + 1
                if _agree(stop["flag"], dev):
                    break
                if done % tc.checkpoint_every == 0:
                    cm.save_async(done, state, extra=data.state_dict())
                    saved = done
    finally:
        signal.signal(signal.SIGTERM, prev)
    cm.wait()
    if done > saved:
        cm.save(done, state, extra=data.state_dict())
    dp = 1 if mesh is None else dp_size(mesh)
    if lead:
        print(f"[train] done: {done} steps, dp={dp}, stragglers="
              f"{stragglers}, dedup_dropped={data.dropped}")
    return {"start": start, "steps": done, "stragglers": stragglers,
            "last": last, "state": state, "dp": dp}


if __name__ == "__main__":
    main()
