"""FLOP / byte accounting by watching every aten op a function dispatches
(the counterpart of ``repro.launch.jaxpr_cost``, named for what torch
walks in place of a jaxpr).

:func:`dispatch_cost` runs ``fn`` on fake tensors (``FakeTensorMode``:
shapes and types only, nothing allocated, so a full-width train step costs
no memory) under a ``TorchDispatchMode`` that counts each aten op as it
runs.  Eager torch runs every layer of the Python loop over blocks and,
inside ``backward``, the recompute that ``torch.utils.checkpoint`` (remat)
inserts, op by op: the reference's scan trip-count multipliers and its
remat handling fall out of the walk.  On fake (CPU) tensors
``ops.flash_attention`` takes its plain version, so the count is the work
of the function, whatever implements it.  On DTensors the mode sees each
op once, at the global shapes (DTensor's local ops run below it).

Conventions (the reference's): matrix products (``mm``, ``addmm``,
``bmm``, ``baddbmm``, ``_scaled_dot_product_*``, ``convolution``) count
2·M·N·K (batch included); other ops their output size, reductions their
input size; views, aliases and metadata count nothing.  ``bytes_upper``
is every counted op's operands plus results (an upper bound: no fusion);
``bytes_major`` only the ops that move through HBM under perfect
elementwise fusion (products, gather / scatter / ``index_*``, ``sum`` /
``amax`` / ``amin``, ``sort``, ``topk``, ``cumsum``) plus the program's
inputs and outputs.
"""
from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only


#: products: op -> FLOPs from (args, outputs)
_PRODUCTS = {
    "mm": lambda a, o: 2.0 * _numel(o[0]) * a[0].shape[-1],
    "addmm": lambda a, o: 2.0 * _numel(o[0]) * a[1].shape[-1],
    "bmm": lambda a, o: 2.0 * _numel(o[0]) * a[0].shape[-1],
    "baddbmm": lambda a, o: 2.0 * _numel(o[0]) * a[1].shape[-1],
    "convolution": lambda a, o: 2.0 * _numel(o[0]) * math.prod(
        a[1].shape[1:]),
}
#: reductions: counted at their input size
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "var", "std", "norm", "linalg_vector_norm",
               "argmax", "argmin", "all", "any", "var_mean"}
#: fusion barriers of the reference (``_MAJOR_PRIMS``), by aten name
_MAJOR = {"mm", "addmm", "bmm", "baddbmm", "convolution", "gather",
          "scatter", "scatter_add", "scatter_reduce", "index",
          "index_put", "index_select", "index_add", "index_copy",
          "embedding", "embedding_dense_backward", "sum", "amax", "amin",
          "sort", "topk", "cumsum"}
#: ops that move and compute nothing (views, aliases, metadata)
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute",
         "transpose", "t", "slice", "select", "unsqueeze", "squeeze",
         "as_strided", "alias", "detach", "split", "split_with_sizes",
         "unbind", "chunk", "diagonal", "unfold", "_reshape_alias",
         "lift_fresh", "empty", "empty_like", "empty_strided", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "_local_scalar_dense", "set_", "resize_", "new_empty",
         "new_empty_strided", "real", "view_as_real"}


def _numel(t) -> int:
    return math.prod(t.shape)


def _bytes(t) -> int:
    return _numel(t) * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _name(func) -> str:
    """``aten.mm.default`` -> ``mm``; in-place ``add_`` -> ``add``."""
    name = func._overloadpacket.__name__
    if name.startswith("_scaled_dot_product"):
        return "_scaled_dot_product_attention"
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _sdpa_flops(args, outs, backward: bool) -> float:
    """2 products of 2·B·H·Sq·Sk·hd forward; 4 (dq, dk, dv, dp) backward."""
    q, k = args[0], args[1]
    flops = 2.0 * 2.0 * _numel(q) * k.shape[-2]
    return 2.0 * flops if backward else flops


class CostMode(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_major = 0.0
        self.by_op: dict[str, float] = defaultdict(float)
        self.bytes_by_shape: dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _name(func)
        if name in _FREE:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        by = sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)
        if name in _PRODUCTS:
            fl = _PRODUCTS[name](args, outs)
        elif name == "_scaled_dot_product_attention":
            fl = _sdpa_flops(args, outs,
                             func._overloadpacket.__name__.endswith(
                                 "backward"))
        elif name in _REDUCTIONS and ins:
            fl = float(_numel(ins[0]))
        else:
            fl = float(sum(_numel(t) for t in outs))
        self.flops += fl
        self.bytes += by
        self.by_op[name] += fl
        if name in _MAJOR or name == "_scaled_dot_product_attention":
            self.bytes_major += by
            shape = "x".join(str(d) for d in outs[0].shape) if outs else ""
            self.bytes_by_shape[f"{name}:{shape}"] += by
        return out


#: the product ops, whose FLOPs the reference books under ``dot_general``
DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "_scaled_dot_product_attention")


def dispatch_cost(fn, *args, fake: bool = True, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` (on fake tensors unless ``fake=False``:
    then on the tensors given, e.g. fake DTensors already made) and return
    its FLOP / byte totals: ``flops``, ``dot_flops`` (the products),
    ``bytes_upper``, ``bytes_major`` (with the program's inputs and
    outputs), ``top_flop_prims`` (8 ops), ``top_byte_ops`` (10 op:shape
    keys of the major ops)."""
    mode = CostMode()
    if fake:
        with FakeTensorMode(allow_non_fake_inputs=True) as fm:
            args, kwargs = tree_map_only(
                torch.Tensor, fm.from_tensor, (args, kwargs))
            with mode:
                out = fn(*args, **kwargs)
    else:
        with mode:
            out = fn(*args, **kwargs)
    io = sum(_bytes(t) for t in _tensors((args, kwargs))) \
        + sum(_bytes(t) for t in _tensors(out))
    top = sorted(mode.by_op.items(), key=lambda kv: -kv[1])[:8]
    top_b = sorted(mode.bytes_by_shape.items(), key=lambda kv: -kv[1])[:10]
    return {
        "flops": mode.flops,
        "dot_flops": sum(mode.by_op.get(k, 0.0) for k in DOT_OPS),
        "bytes_upper": mode.bytes,
        "bytes_major": mode.bytes_major + io,
        "top_flop_prims": dict(top),
        "top_byte_ops": dict(top_b),
    }
