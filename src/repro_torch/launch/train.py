"""Training launcher of the port: the train loop with checkpoints, resume,
preemption and straggler accounting (the port of ``repro.launch.train``),
on one device.

* periodic async checkpoints + automatic resume from the latest one (a
  restart continues the same trajectory: the data stream is a function of
  the step);
* preemption: SIGTERM sets a flag, the loop writes a final checkpoint and
  exits cleanly;
* per-step deadline straggler detection (logged and counted).

The reference shards the state and the batch over a device mesh; the port
runs one device (the mesh and the sharded launcher are ROADMAP A-7), and
its last line says so (``dp=1``).

Usage (on the card; ``--device cpu`` runs the plain kernels on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --device cpu --steps 20 --out /tmp/t
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs import get_config
from ..core.simulator import resolve_device
from ..data.pipeline import DataConfig, SyntheticLM
from ..models.config import TrainConfig
from ..train import step as TS


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
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=tc.seed,
                                  dedup=True), device=dev)
    step_fn = TS.build_train_step(cfg, tc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(tc.seed)
    state = TS.init_state(gen, cfg, tc, dev)
    cm = CheckpointManager(args.out, keep=tc.keep_checkpoints)
    start = 0
    if cm.latest_step() is not None:
        start, state = cm.restore(state)
        data.load_state_dict(cm.manifest(start)["extra"])
        print(f"[train] resumed from step {start}")

    stop = {"flag": False}

    def on_term(_sig, _frm):
        print("[train] preemption signal: checkpoint + exit")
        stop["flag"] = True

    prev = signal.signal(signal.SIGTERM, on_term)
    log_path = os.path.join(args.out, "metrics.jsonl")
    stragglers, done, saved, last = 0, start, start, {}
    try:
        with open(log_path, "a") as logf:
            for step in range(start, args.steps):
                t0 = time.time()
                state, metrics = step_fn(state, data.batch(step))
                rec = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                if args.step_deadline_s and dt > args.step_deadline_s:
                    stragglers += 1
                    print(f"[train] straggler: step {step} took {dt:.2f}s")
                last = {"step": step, "dt_s": round(dt, 4), **rec}
                logf.write(json.dumps(last) + "\n")
                if step % 10 == 0:
                    print(f"[train] step {step} loss {rec['loss']:.4f} "
                          f"acc {rec['accuracy']:.3f} {dt:.2f}s")
                done = step + 1
                if stop["flag"]:
                    break
                if done % tc.checkpoint_every == 0:
                    cm.save_async(done, state, extra=data.state_dict())
                    saved = done
    finally:
        signal.signal(signal.SIGTERM, prev)
    cm.wait()
    if done > saved:
        cm.save(done, state, extra=data.state_dict())
    print(f"[train] done: {done} steps, dp=1, stragglers={stragglers}, "
          f"dedup_dropped={data.dropped}")
    return {"start": start, "steps": done, "stragglers": stragglers,
            "last": last, "state": state}


if __name__ == "__main__":
    main()
