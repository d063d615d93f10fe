"""§Perf hillclimb: hypothesis -> change -> re-run -> measure (the
port of ``repro.launch.hillclimb``).

Runs named optimization variants of three cells through the dry-run
(``dryrun.build_cell`` / ``measure``: fake tensors, a fake group of 256
ranks), records the roofline terms per variant and writes the iteration
log.  Variants compose config overrides (remat policy, MoE capacity),
microbatching and logical mesh remaps (the same 256 ranks, another axis
split).  The reference's ``fused_attention`` variants change nothing in
the port — every attention already runs the fused region's kernels
(``models/config.py``) — and their records say so (``"no_effect"``) rather
than invent a change.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell musicgen \\
      [--out experiments/perf_torch]
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import get_config
from . import dryrun as DR
from .mesh import fake_group, make_mesh, make_production_mesh

#: overrides that do nothing in the port: every attention is fused
_NO_EFFECT = {"fused_attention": "every attention of the port runs the "
                                 "fused region's kernels already"}


def _mesh_for(remesh: str | None):
    if not remesh:
        return make_production_mesh(device="cpu"), "pod16x16"
    d, m = remesh.split("x")
    return make_mesh((int(d), int(m)), ("data", "model"), "cpu"), \
        f"remap{remesh}"


def run_variant(arch: str, shape_name: str, variant: str, *,
                overrides: dict | None = None, remesh: str | None = None,
                microbatches: int | None = None,
                hypothesis: str = "") -> dict:
    """One variant of a cell -> its record (roofline terms, cost,
    collectives, per-device argument bytes)."""
    overrides = dict(overrides or {})
    no_effect = {k: _NO_EFFECT[k] for k in overrides if k in _NO_EFFECT}
    cfg = get_config(arch).replace(**overrides)
    t0 = time.time()
    with fake_group(256):
        mesh, mesh_name = _mesh_for(remesh)
        with FakeTensorMode(allow_non_fake_inputs=True):
            cfg, shape, fn, args, specs = DR.build_cell(
                arch, shape_name, mesh, cfg=cfg, microbatches=microbatches)
            rec = DR.measure(cfg, shape, fn, args, specs, mesh)
    dc = rec["dispatch_cost"]
    record = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": mesh_name, "hypothesis": hypothesis,
        "overrides": overrides, "no_effect": no_effect,
        "dispatch_cost": {k: v for k, v in dc.items()
                          if not isinstance(v, dict)},
        "top_byte_ops": dc["top_byte_ops"],
        "collectives": rec["collectives"], "memory": rec["memory"],
        "roofline": rec["roofline"], "wall_s": round(time.time() - t0, 1),
    }
    r = record["roofline"]
    print(f"[{arch} x {shape_name}] {variant:28s} "
          f"compute {r['compute_s']:.4f}  memory {r['memory_s']:.4f}  "
          f"coll {r['collective_s']:.4f}  -> bound {r['bound_s']:.4f} "
          f"({r['dominant']}), roofline {r['roofline_fraction']:.3f}"
          + (f"  [no effect: {', '.join(no_effect)}]" if no_effect else ""),
          flush=True)
    return record


CELLS = {
    "musicgen": ("musicgen-medium", "train_4k", [
        ("baseline", {}, dict()),
        ("fused_attention",
         dict(overrides={"fused_attention": True}),
         dict(hypothesis="88% of memory bytes are flash score/softmax "
              "spills (jaxpr top_byte_ops); fusing attention keeps them in "
              "VMEM -> memory term drops ~5x; collective term unaffected")),
        ("fused+remesh_d32m8",
         dict(overrides={"fused_attention": True}, remesh="32x8"),
         dict(hypothesis="24 heads do not divide TP=16 -> GSPMD replicates "
              "attention activations and all-gathers qkv every layer "
              "(2.5GB fwd / 7.5GB bwd per layer iter = the 9.7s collective "
              "bound). TP=8 divides 24 -> pure head-parallel attention, "
              "no all-gathers; per-device AR bytes also halve via dp=32 -> "
              "collective term -90%+")),
        ("fused+remesh+dots_remat",
         dict(overrides={"fused_attention": True, "remat": "block_dots"},
              remesh="32x8"),
         dict(hypothesis="block remat recomputes every dot in the refwd "
              "(~1.33x dot flops); saving dot outputs removes recompute -> "
              "compute term -15-25%")),
    ]),
    "mamba2": ("mamba2-780m", "prefill_32k", [
        ("baseline", {}, dict()),
        ("remesh_d32m8",
         dict(remesh="32x8"),
         dict(hypothesis="collective term = 48 per-layer TP all-reduces + "
              "B/C all-gathers of (B/dp, S, *) activations; halving TP "
              "(16->8) and doubling DP halves per-device collective bytes "
              "-> collective term -50%, compute unchanged")),
        ("remesh_d64m4",
         dict(remesh="64x4"),
         dict(hypothesis="push further: TP=4 quarters collective bytes; "
              "B=32 < dp=64 leaves batch under-sharded -> expect "
              "divisibility fallback; check net effect")),
    ]),
    "qwen2moe": ("qwen2-moe-a2.7b", "train_4k", [
        ("baseline", {}, dict()),
        ("fused_attention",
         dict(overrides={"fused_attention": True}),
         dict(hypothesis="~72% of memory bytes are attention intermediates "
              "-> fuse; MoE dispatch gather/scatter (8.7e12 B) remains")),
        ("fused+dots_remat",
         dict(overrides={"fused_attention": True, "remat": "block_dots"}),
         dict(hypothesis="remove expert-matmul recompute in refwd")),
        ("fused+dots+cap1.0",
         dict(overrides={"fused_attention": True, "remat": "block_dots",
                         "capacity_factor": 1.0}),
         dict(hypothesis="capacity 1.25->1.0 cuts expert compute+bytes 20% "
              "at the cost of more dropped tokens (quality trade, "
              "documented)")),
    ]),
}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS) + ["all"], default="all")
    ap.add_argument("--out", default="experiments/perf_torch")
    args = ap.parse_args(argv)
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for cell in cells:
        arch, shape, variants = CELLS[cell]
        records = []
        for vname, kw, meta in variants:
            try:
                records.append(run_variant(arch, shape, vname, **kw, **meta))
            except Exception as e:  # report-and-continue, as the dry-run
                traceback.print_exc()
                records.append({"arch": arch, "shape": shape,
                                "variant": vname, "error": repr(e)})
                failures.append((cell, vname, repr(e)))
        with open(os.path.join(args.out, f"{cell}.json"), "w") as f:
            json.dump(records, f, indent=1)
    for f in failures:
        print("[hillclimb] FAILED", *f)
    print("[hillclimb] done")


if __name__ == "__main__":
    main()
