"""Atomic, async checkpoints of the port's train state (the port of
``repro.ckpt.checkpoint``).

* **Atomic**: a checkpoint directory is staged as ``step_N.tmp`` and
  renamed into place only after the arrays and the manifest are written
  (the manifest fsync'd): a preempted writer never corrupts the latest good
  checkpoint.
* **Async**: :meth:`CheckpointManager.save_async` copies the state to host
  memory first (the train loop blocks only for the device -> host copy)
  and writes it on a background thread.
* **Self-describing**: the manifest records each leaf's name, shape and
  dtype and the step; :meth:`CheckpointManager.restore` fills a template
  of the same structure and raises ``KeyError`` for a missing leaf and
  ``ValueError`` for a shape mismatch.
* **Garbage-collected**: only the newest ``keep`` checkpoints stay.

Leaves are named by their path in the port's dict / list tree
(``params/blocks/3/attn/wq``).  A bf16 leaf is stored as its int16 bits,
its dtype in the manifest (numpy has no bfloat16 without ``ml_dtypes``).

**On a mesh** (a state of DTensors, ``launch/sharding.py``) a save
gathers every leaf (``full_tensor``, which every rank calls) and rank 0
writes the same one-file format; ranks meet at a barrier after a
synchronous save.  :meth:`CheckpointManager.restore` places each leaf as
its template leaf is placed (a DTensor template: its mesh and placements)
or by ``shardings=``, a tree of ``(mesh, placements)``: an elastic restore
onto a mesh other than the one that saved, or onto one process.  The
reference's docstring promises per-process shard files; its code gathers
every leaf and writes one ``arrays.npz``, which is what this port does
(ROADMAP C-11).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _flatten(tree, prefix: str = "", leaf=None) -> dict[str, object]:
    """{leaf name: leaf} of a dict / list tree, in order (``leaf(x)``
    true: ``x`` is a leaf, not a container)."""
    if leaf is not None and leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: dict[str, object] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k), leaf))
    return out


def _unflatten_like(tree, leaves: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten_like(v, leaves, f"{prefix}/{i}" if prefix
                                else str(i)) for i, v in enumerate(tree)]
    return leaves[prefix]


def _writer() -> bool:
    """This process writes checkpoints: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(t) -> tuple[np.ndarray, str]:
    """-> (a host copy as a numpy array, dtype name); bf16 as its int16
    bits; a DTensor gathered first (a collective: every rank calls it)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = torch.as_tensor(t).detach()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy(), name


def _from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, order="C"))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------- save -------------
    def save(self, step: int, state, *, extra: dict | None = None) -> str:
        """Write ``state`` as checkpoint ``step`` now; -> its directory.
        On a mesh every rank calls it, rank 0 writes, all leave together."""
        host = self._host(state)
        final = os.path.join(self.dir, f"step_{step:010d}")
        if _writer():
            final = self._write(step, host, extra or {})
        if dist.is_initialized():
            dist.barrier()
        return final

    def save_async(self, step: int, state, *,
                   extra: dict | None = None) -> None:
        """Copy ``state`` to the host now (on a mesh: gather it, every rank
        calls), write it on a thread of rank 0 (after any write still in
        flight)."""
        self.wait()
        host = self._host(state)
        if not _writer():
            return

        def work():
            self._write(step, host, extra or {})

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _host(state) -> dict[str, tuple[np.ndarray, str]]:
        return {name: _to_host(t) for name, t in _flatten(state).items()}

    def _write(self, step: int, host: dict, extra: dict) -> str:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "leaves": {}}
        arrays = {}
        for name, (arr, dtype) in host.items():
            key = re.sub(r"[^A-Za-z0-9_./-]", "_", name)
            arrays[key] = arr
            manifest["leaves"][name] = {"file_key": key,
                                        "shape": list(arr.shape),
                                        "dtype": dtype}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------- restore -------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:010d}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, template, step: int | None = None, *,
                device=None, shardings=None) -> tuple[int, object]:
        """Restore checkpoint ``step`` (default: the latest) into the
        structure of ``template``; each leaf lands on ``device`` (default:
        its template leaf's device) in the dtype it was saved with, placed
        by ``shardings`` (a tree of ``(mesh, placements)`` of the same
        structure) or, for a DTensor template leaf, as that leaf.  Every
        rank reads the file: placing needs no communication.
        -> (step, state)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        manifest = self.manifest(step)
        places = {}
        if shardings is not None:
            places = _flatten(shardings, leaf=lambda x: isinstance(x, tuple))
        leaves = {}
        with np.load(os.path.join(self.dir, f"step_{step:010d}",
                                  "arrays.npz")) as data:
            for name, tmpl in _flatten(template).items():
                meta = manifest["leaves"].get(name)
                if meta is None:
                    raise KeyError(f"checkpoint missing leaf {name}")
                arr = data[meta["file_key"]]
                shape = tuple(torch.as_tensor(tmpl).shape)
                if tuple(arr.shape) != shape:
                    raise ValueError(f"shape mismatch for {name}: ckpt "
                                     f"{arr.shape} vs template {shape}")
                dev = device if device is not None else \
                    torch.as_tensor(tmpl).device
                t = _from_host(arr, meta["dtype"], dev)
                where = places.get(name)
                if where is None and isinstance(tmpl, DTensor):
                    where = (tmpl.device_mesh, tmpl.placements)
                if where is not None:
                    t = distribute_tensor(t, where[0], list(where[1]),
                                          src_data_rank=None)
                leaves[name] = t
        return step, _unflatten_like(template, leaves)
