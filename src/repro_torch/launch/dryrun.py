"""Multi-pod dry-run: one train / prefill / decode step of every (arch x
shape x mesh) cell on fake tensors and a fake process group (the port of
``repro.launch.dryrun``).

Proves the distribution config is coherent without hardware: a cell opens
a fake process group of 256 (or 512) ranks (``mesh.fake_group``), builds
the production mesh, makes the state / parameters / caches and the inputs
as fake tensors (``FakeTensorMode``: nothing allocated, at full width),
places them as DTensors by ``sharding.py`` and runs one step as rank 0 —
the counterpart of the reference's lower + compile.  It records:

* per-device argument bytes, from the local shard shapes (and, the same
  number, from the specs alone: :func:`spec_bytes`);
* the step's FLOPs and bytes (:func:`dispatch_cost.dispatch_cost` of the
  unsharded step on the same fake tensors);
* the collectives the sharded step issues (``roofline.collective_bytes``);
* the roofline terms on H100s and the parameter / active-parameter counts.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
      [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import ARCHS, SHAPES, SKIPS, get_config
from ..models import transformer as T
from ..models.config import ModelConfig, ShapeConfig, TrainConfig
from ..train import step as TS
from . import dispatch_cost as DC
from . import roofline as RL
from .mesh import axis_sizes, fake_group, make_production_mesh
from .sharding import (batch_specs, cache_specs, distribute_tree, leaf_paths,
                       param_specs, state_specs)

#: per-arch gradient-accumulation plan for train_4k (activation-memory knob)
MICROBATCHES = {
    "llama3-405b": 8, "llama-3.2-vision-90b": 8, "grok-1-314b": 8,
    "minitron-8b": 2, "granite-3-8b": 2, "qwen3-4b": 2,
    "qwen2-moe-a2.7b": 2, "musicgen-medium": 1, "hymba-1.5b": 1,
    "mamba2-780m": 1,
}


def train_config_for(arch: str) -> TrainConfig:
    return TrainConfig(n_microbatches=MICROBATCHES.get(arch, 1))


# ---------------------------------------------------------------------------
# input_specs: tensor stand-ins for every model input (fake under the mode)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Zero tensors of every input's shape and type; made under
    ``FakeTensorMode`` they are shapes only."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        batch = {"tokens": torch.zeros((b, s), dtype=i32),
                 "labels": torch.zeros((b, s), dtype=i32),
                 "loss_mask": torch.zeros((b, s), dtype=torch.float32)}
    elif shape.kind == "prefill":
        batch = {"tokens": torch.zeros((b, s), dtype=i32),
                 "positions": torch.zeros((b, s), dtype=i32)}
    else:   # decode: one new token against an S-long cache
        batch = {"tokens": torch.zeros((b, 1), dtype=i32),
                 "positions": torch.zeros((b, 1), dtype=i32)}
    if cfg.cross_attn_every:
        batch["image_embeds"] = torch.zeros((b, cfg.n_image_tokens,
                                             cfg.d_model), dtype=bf16)
    if cfg.audio_frontend_stub and shape.kind != "decode":
        batch["input_embeds"] = torch.zeros((b, s, cfg.d_model), dtype=bf16)
    return batch


def _prefill_step_fn(cfg: ModelConfig):
    """Prefill: full forward + last-token logits (serving semantics)."""
    def prefill_step(params, batch):
        with torch.no_grad(), implicit_replication():
            return T.forward(params, cfg, batch)[:, -1, :]
    return prefill_step


def _decode_step_fn(cfg: ModelConfig):
    def serve_step(params, caches, batch):
        with torch.no_grad(), implicit_replication():
            logits, new_caches = T.decode_step(
                params, cfg, batch["tokens"], caches, batch["positions"],
                image_embeds=batch.get("image_embeds"))
        return logits[:, -1, :], new_caches
    return serve_step


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------
def spec_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of ``tree`` placed by ``specs`` on ``mesh``, from
    the shapes and the specs alone (each sharded dimension split, rounded
    up, over the product of its axes)."""
    sizes = axis_sizes(mesh)
    spec_at = dict(leaf_paths(specs))
    total = 0
    for path, t in leaf_paths(tree):
        spec = spec_at[path]
        n = 1
        for d, dim in enumerate(t.shape):
            entry = spec[d] if d < len(spec) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= -(-dim // math.prod(sizes[a] for a in axes))
        total += n * t.element_size()
    return total


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of DTensors."""
    return sum(t.to_local().numel() * t.element_size()
               for _p, t in leaf_paths(tree) if isinstance(t, DTensor))


def build_cell(arch: str, shape_name: str, mesh, *,
               compression: str = "none", cfg: ModelConfig | None = None,
               microbatches: int | None = None):
    """The step function and its global (fake) arguments with their specs,
    under an active ``FakeTensorMode``: -> (cfg, shape, fn, args, specs)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    gen = torch.Generator().manual_seed(0)
    batch = input_specs(cfg, shape)
    b_spec = batch_specs(batch, mesh)
    if shape.kind == "train":
        tc = train_config_for(arch)
        tc = TrainConfig(n_microbatches=microbatches or tc.n_microbatches,
                         grad_compression=compression)
        state = TS.init_state(gen, cfg, tc, "cpu")
        return (cfg, shape, TS.build_train_step(cfg, tc), (state, batch),
                (state_specs(cfg, state, mesh), b_spec))
    params = T.init_params(gen, cfg)
    p_spec = param_specs(cfg, params, mesh)
    if shape.kind == "prefill":
        return (cfg, shape, _prefill_step_fn(cfg), (params, batch),
                (p_spec, b_spec))
    caches = T.init_caches(cfg, shape.global_batch, shape.seq_len,
                           dtype=torch.bfloat16, device="cpu")
    return (cfg, shape, _decode_step_fn(cfg), (params, caches, batch),
            (p_spec, cache_specs(cfg, caches, mesh), b_spec))


@contextlib.contextmanager
def _strided_offsets_off_fake():
    """DTensor's ``_StridedShard.local_shard_size_and_offset`` (used when
    it plans a redistribution of a dimension sharded over two mesh axes)
    reads shard offsets from a ``torch.arange`` it makes; under
    ``FakeTensorMode`` that tensor is fake and cannot be read, so the
    helper runs with the fake mode lifted (it touches no argument)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.local_shard_size_and_offset

    def lifted(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = lifted
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def measure(cfg, shape, fn, args, specs, mesh) -> dict:
    """Place the fake arguments, run the sharded step as rank 0 counting
    its collectives, and count the unsharded step's FLOPs and bytes
    (under an active ``FakeTensorMode``)."""
    n_dev = mesh.size()
    pairs = list(zip(args, specs, strict=True))
    arg_spec_bytes = sum(spec_bytes(a, s, mesh) for a, s in pairs)
    placed = [distribute_tree(a, s, mesh, src_data_rank=None)
              for a, s in pairs]
    arg_bytes = sum(_local_bytes(a) for a in placed)
    t0 = time.time()
    with _strided_offsets_off_fake():
        _out, coll = RL.collective_bytes(fn, *placed)
    t_sharded = time.time() - t0
    del placed, _out
    t0 = time.time()
    cost = DC.dispatch_cost(fn, *args, fake=False)
    t_cost = time.time() - t0
    record = {
        "devices": n_dev,
        "memory": RL.memory_dict({
            "argument_bytes": arg_bytes,
            "argument_bytes_from_specs": arg_spec_bytes}),
        "dispatch_cost": cost, "collectives": coll,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "sharded_step_s": t_sharded, "cost_step_s": t_cost,
    }
    record["roofline"] = RL.roofline_terms(record, cfg, shape, n_dev)
    return record


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str | None = None, compression: str = "none") -> dict:
    """One (arch x shape x mesh) cell on a fake group of 256 / 512 ranks;
    -> its record (written to ``out_dir`` as JSON when given)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    t0 = time.time()
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            cfg, shape, fn, args, specs = build_cell(
                arch, shape_name, mesh, compression=compression)
            record = measure(cfg, shape, fn, args, specs, mesh)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "kind": shape.kind, "compression": compression,
              "wall_s": time.time() - t0, **record}
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
          f"{record['wall_s']:.1f}s bytes/dev "
          f"{record['memory']['argument_bytes']} collectives "
          f"{record['collectives']['total_bytes']}", flush=True)
    print(json.dumps(record["roofline"], indent=1), flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--compression", default="none")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        if (arch, shape) in SKIPS:
            print(f"[dryrun] SKIP {arch} x {shape}: {SKIPS[(arch, shape)]}")
            continue
        for mp in meshes:
            try:
                run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                         compression=args.compression)
            except Exception as e:  # report-and-continue CLI
                traceback.print_exc()
                failures.append((arch, shape, mp, repr(e)))
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\n[dryrun] all cells ran OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
