"""Where the time of the serving path goes, on one CUDA device.

    python -m repro_torch.serve_profile [--arch qwen3-4b]
        [--out build/serve_profile.json]

A config of ``configs/`` uncut (``--arch``: ``configs/qwen3_4b.py`` by
default; also every other family the engine serves — qwen2-moe-a2.7b,
hymba-1.5b, mamba2-780m, musicgen-medium; random bf16 weights from a
seeded generator) behind ``ServeEngine`` with 4 slots of 4096 tokens and
the float32 cache.  Three cells, each measured as ``mc_profile.measure``
does (wall = median of ``REPS`` untraced calls ending in a synchronize;
device time per kernel from one ``torch.profiler`` trace; busy share =
device time / wall):

* ``serve_prefill`` — one prefill of a ``PREFILL_LEN``-token prompt into a
  slot's caches (``_prefill_fn`` and the greedy sample of the first
  token, what ``ServeEngine._admit`` runs per request);
* ``serve_decode`` — one ``ServeEngine.step`` with all four slots active,
  their positions between 1024 and 2048: one replay of the engine's CUDA
  graph of ``decode_step`` and one host read of the four greedy tokens;
  beside it ``replay_ms``, the device time of one replay alone from CUDA
  events (the mean over ``REPS`` replays queued back to back), and the
  SM clock, temperature and power draw right after (``clocks_after``);
* ``serve_decode_eager`` — the same step as the engine ran it before the
  graph, on the same engine state: ``decode_step`` op by op from Python
  and one host read per slot (the engine's caches are written at the
  slots' current positions, which the next graphed step writes again).

Prints one JSON object and writes it to ``--out``.  Needs a CUDA device;
without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .mc_profile import measure

ARCH, SLOTS, MAX_LEN, PREFILL_LEN, REPS = "qwen3-4b", 4, 4096, 2048, 5
#: prompt lengths of the four decoding slots
DECODE_PROMPTS = (2048, 1536, 1280, 1024)


def replay_ms(graph) -> float:
    """Device ms of one replay of a CUDA graph: CUDA events around
    ``REPS`` replays queued back to back, over the count."""
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def clocks() -> str:
    """The card's SM clock, temperature and power draw now, as
    ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--out", default="build/serve_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 1
    from .configs import get_config
    from .models import transformer as T
    from .serve.engine import ServeEngine, _prefill_fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    eng = ServeEngine(cfg, params, n_slots=SLOTS, max_len=MAX_LEN)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(2, cfg.vocab, (1, PREFILL_LEN))
                              ).cuda()
    valid = torch.ones_like(prompt, dtype=torch.bool)

    def prefill():
        logits, _ = _prefill_fn(params, cfg, prompt, valid,
                                eng._slot_caches(0))
        return int(torch.argmax(logits[0]))

    cells = {"serve_prefill": measure(prefill, REPS)}
    for n in DECODE_PROMPTS:
        eng.submit(rng.integers(2, cfg.vocab, n).tolist(),
                   max_new_tokens=MAX_LEN)
    eng.step()                        # admits the four prompts
    cells["serve_decode"] = measure(eng.step, REPS)
    cells["serve_decode"]["replay_ms"] = replay_ms(eng.graph.graph)
    cells["serve_decode"]["clocks_after"] = clocks()

    def eager_step():
        toks = torch.from_numpy(eng.slot_next[:, None].astype(np.int64))
        pos = torch.from_numpy(eng.slot_pos[:, None].copy())
        with torch.no_grad():
            logits, _ = T.decode_step(params, cfg, toks.cuda(), eng.caches,
                                      pos.cuda())
        return [int(torch.argmax(logits[i, 0])) for i in range(SLOTS)]

    cells["serve_decode_eager"] = measure(eager_step, REPS)
    out = {"card": smi, "arch": args.arch, "slots": SLOTS, "max_len": MAX_LEN,
           "prefill_len": PREFILL_LEN, "decode_prompts": DECODE_PROMPTS,
           "decode_positions_after": [int(p) for p in eng.slot_pos],
           "cells": cells}
    text = json.dumps(out, indent=1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
