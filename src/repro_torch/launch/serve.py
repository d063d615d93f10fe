"""Serving launcher of the port: batched prefill/decode with the slot engine.

Every architecture whose engine the reference can run: attention, MoE,
SSM, hybrid and the audio decoder (a cross-attention config raises, as
``ServeEngine`` does: ROADMAP C-9).

Usage (on the card; ``--device cpu`` runs the plain attention on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --smoke --requests 8 --max-new 16 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.simulator import resolve_device
from ..models import transformer as T
from ..serve.engine import ServeEngine


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    eng = ServeEngine(cfg, params, n_slots=args.slots, max_len=args.max_len,
                      device=dev)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(args.requests):
        # the reference's 4-23 tokens, cut to what the cache holds (a
        # sliding window's ring: hymba's smoke config keeps 16 slots)
        plen = int(rng.integers(4, min(24, (eng.max_prompt or 23) + 1)))
        prompt = rng.integers(2, cfg.vocab, plen).tolist()
        eng.submit(prompt, max_new_tokens=args.max_new,
                   temperature=args.temperature)
    done = eng.run()
    dt = time.time() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    decode_ms = 1e3 * float(np.median(eng.decode_s)) if eng.decode_s \
        else float("nan")
    print(f"[serve] {len(done)} requests, {tokens} tokens, "
          f"{dt:.2f}s, {tokens / dt:.1f} tok/s, decode {decode_ms:.3f} ms "
          f"per step (median of {len(eng.decode_s)}) on {dev}")
    for r in done[:3]:
        print(f"  req {r.rid}: {len(r.prompt)}-token prompt -> "
              f"{r.out_tokens[:8]}...")
    return done


if __name__ == "__main__":
    main()
