"""Roofline terms of a (arch x shape x mesh) cell on H100s (the port of
``repro.launch.roofline``).

Three terms, in seconds per device:

  compute    = FLOPs / devices / PEAK_FLOPS       [dense bf16 peak]
  memory     = bytes / devices / HBM_BW           [HBM bandwidth]
  collective = collective bytes per device / LINK_BW   [NVLink, one way]

FLOPs and bytes are the global totals of :func:`dispatch_cost` (every
layer and the remat recompute counted as they run).  Collective bytes are
those of the collectives a step on DTensors issues (:func:`collective_bytes`,
counted per call by ``CommDebugMode``): all-gather, all-reduce,
reduce-scatter and all-to-all, each call's result bytes.  The reference
parses XLA's post-partitioning HLO text for them and multiplies each
while-body by its trip count; torch produces no HLO, and eager execution
issues a collective once per loop iteration, which is that multiplier.

MODEL_FLOPS sanity: 6·N·D for training (N parameters, D tokens), 2·N·D
for inference, with MoE's active parameters; MODEL_FLOPS / FLOPs exposes
the remat and redundancy overhead.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense, no sparsity, at the 700 W limit)
PEAK_FLOPS = 989e12        # bf16 tensor-core FLOP/s per device
HBM_BW = 3.35e12           # HBM3 bytes/s per device
LINK_BW = 450e9            # NVLink bytes/s per device, each way

#: the DTensor collectives counted, by the reference's names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


class CollectiveCounter:
    """Counts collectives and their result bytes while a step runs:

        with CollectiveCounter() as cc:
            step(state, batch)
        cc.result()

    A ``TorchDispatchMode`` (torch's ``CommDebugMode`` beneath it counts
    the calls per op) that adds up each ``_c10d_functional`` collective's
    result bytes."""

    def __init__(self):
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Bytes(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                kind = _COLLECTIVES.get(func._overloadpacket.__name__)
                if kind is not None and \
                        func.namespace in ("_c10d_functional",
                                           "c10d_functional"):
                    counter.bytes[kind] += _result_bytes(out)
                    counter.counts[kind] += 1
                return out

        self.bytes = {k: 0 for k in sorted(set(_COLLECTIVES.values()))}
        self.counts = dict.fromkeys(self.bytes, 0)
        self._comm = CommDebugMode()
        self._bytes_mode = _Bytes()

    def __enter__(self):
        self._comm.__enter__()
        self._bytes_mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes_mode.__exit__(*exc)
        self._comm.__exit__(*exc)

    def result(self) -> dict:
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": int(sum(self.bytes.values())),
                "comm_debug_total_counts": self._comm.get_total_counts()}


def _result_bytes(out) -> int:
    import torch
    from torch.utils._pytree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(out)[0]
               if isinstance(t, torch.Tensor))


def collective_bytes(fn, *args, **kwargs) -> tuple[object, dict]:
    """Run ``fn(*args, **kwargs)`` counting its collectives -> (its
    result, {"bytes", "counts" per kind, "total_bytes"})."""
    with CollectiveCounter() as cc:
        out = fn(*args, **kwargs)
    return out, cc.result()


def memory_dict(mem) -> dict:
    """A memory record as {name: int bytes}: the ``*_bytes`` values of a
    dict (such as :func:`dryrun.run_cell`'s per-device argument bytes) or
    the attributes of an object that has them."""
    if isinstance(mem, dict):
        return {k: int(v) for k, v in mem.items()
                if isinstance(v, (int, float))}
    out = {}
    for attr in ("argument_bytes", "output_bytes", "temp_bytes",
                 "peak_bytes"):
        v = getattr(mem, attr, None)
        if v is not None:
            out[attr] = int(v)
    return out


def model_flops(cfg, shape, kind: str) -> float:
    """6·N·D (train) / 2·N·D (inference) with MoE active params."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens


def roofline_terms(record: dict, cfg, shape, n_dev: int) -> dict:
    """Three-term roofline (per-device seconds) from a record's
    ``dispatch_cost`` (global FLOPs / bytes) and ``collectives`` (per
    device bytes)."""
    dc = record.get("dispatch_cost", {})
    flops_global = float(dc.get("flops", 0.0))
    bytes_global = float(dc.get("bytes_major", dc.get("bytes_upper", 0.0)))
    coll_dev = float(record.get("collectives", {}).get("total_bytes", 0.0))
    t_compute = flops_global / n_dev / PEAK_FLOPS
    t_memory = bytes_global / n_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, shape.kind)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "flops_global": flops_global,
        "useful_flops_ratio": (mf / flops_global) if flops_global else 0.0,
        "bound_s": bound,
        "roofline_fraction": ((mf / n_dev / PEAK_FLOPS) / bound
                              if bound > 0 else 0.0),
    }


def mfu(cfg, shape, wall_s: float, n_dev: int = 1) -> float:
    """Model FLOPs utilisation: ``model_flops`` / wall / devices / the
    data sheet's bf16 peak."""
    return model_flops(cfg, shape, shape.kind) / wall_s / n_dev / PEAK_FLOPS
