"""Where the time of one training step goes, on one CUDA device.

    python -m repro_torch.train_profile [--arch qwen3-4b] [--mesh]
        [--out build/train_profile.json]

``configs/qwen3_4b.py`` (or ``--arch``'s config) uncut (random bf16
weights from a seeded generator, AdamW, remat="block", the reference's
default ``TrainConfig``) trained on 2 x 2048 tokens of ``SyntheticLM``,
the ``train_path`` shape of ``chip_smoke.py``.  ``--mesh`` steps on the
(1, 1) mesh of a one-process NCCL group, the state and batch DTensors
placed by ``launch/sharding.py`` (``mesh_train_path``'s setting), so the
two runs show what the DTensor layer costs on one card.  One cell,
``train_step``, measured as ``mc_profile.measure`` does: wall = median
of ``REPS`` untraced steps ending in a synchronize (after a warm-up
step), device time per kernel from one ``torch.profiler`` trace of one
more step, busy share = device time / wall.  The batch is drawn before the timed calls.  Also prints the
device time of every kernel grouped by kind (matrix products, the
attention forward and backward kernels, the rest: elementwise work, the
optimizer, copies) and the peak memory.

Prints one JSON object and writes it to ``--out``.  Needs a CUDA device;
without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed

from .mc_profile import measure

ARCH, BATCH, SEQ, REPS = "qwen3-4b", 2, 2048, 3

#: substrings of kernel names, by kind (the first that matches)
KINDS = (("attention_bwd", ("bwd_wg", "bwd_prep", "bwd_dkdv", "bwd_dq",
                            "bwd_delta")),
         ("attention_fwd", ("flash_fwd", "flash_combine")),
         ("matmul", ("gemm", "Gemm", "cutlass", "sm90_xmma", "nvjet")))


def _kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def _on_mesh(cfg, state: dict, batch: dict):
    """Open a one-process NCCL group; -> the state and batch placed on its
    (1, 1) mesh by the sharding rules."""
    import socket

    import torch.distributed as dist

    from .launch.mesh import make_host_mesh
    from .launch.sharding import batch_specs, distribute_tree, state_specs
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    mesh = make_host_mesh(device="cuda")
    state = distribute_tree(state, state_specs(cfg, state, mesh), mesh)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    return state, distribute_tree(batch, batch_specs(batch, mesh), mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--mesh", action="store_true",
                    help="step on the (1, 1) mesh of a one-process group")
    ap.add_argument("--out", default="build/train_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    from .configs import get_config
    from .data.pipeline import DataConfig, SyntheticLM
    from .models.config import TrainConfig
    from .train import step as TS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg, tc = get_config(args.arch), TrainConfig()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = TS.init_state(gen, cfg, tc)
    step = TS.build_train_step(cfg, tc)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                   global_batch=BATCH)).batch(0)
    if args.mesh:
        state, batch = _on_mesh(cfg, state, batch)
    try:
        torch.cuda.reset_peak_memory_stats()
        cell = measure(lambda: step(state, batch), REPS, every_kernel=True)
    finally:
        if args.mesh:
            torch.distributed.destroy_process_group()
    by_kind: dict[str, dict] = {}
    for name, k in cell.pop("kernels").items():
        d = by_kind.setdefault(_kind(name), {"device_ms": 0.0, "count": 0})
        d["device_ms"] += k["device_ms"]
        d["count"] += k["count"]
    for d in by_kind.values():
        d["share"] = d["device_ms"] / cell["device_ms"]
    out = {"card": smi, "arch": args.arch, "mesh": args.mesh,
           "batch": BATCH, "seq": SEQ,
           "tokens_per_s": BATCH * SEQ / (cell["wall_ms_median"] / 1e3),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "cells": {"train_step": cell}, "device_ms_by_kind": by_kind}
    text = json.dumps(out, indent=1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
