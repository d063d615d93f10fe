"""Sharding rules of the port (``repro.launch.sharding``): parameter /
state / batch / cache specs per (arch, mesh), and their DTensor
placements.

A spec is the reference's ``PartitionSpec`` as a tuple: per tensor
dimension an axis name, a tuple of axis names (one tensor dimension split
over several mesh axes, ``("pod", "data")``), or ``None``.
:func:`to_placements` turns it into DTensor ``Shard`` / ``Replicate``
placements and :func:`distribute_tree` places a tree by a tree of specs.
Explicit specs go on the boundaries only (parameters, batch, caches);
DTensor's sharding propagation places everything inside and issues the
collectives, as GSPMD does for the reference.  A spec is emitted only
where the axis size divides the mesh axis, so every (arch x shape x mesh)
cell runs.

Parameter rule per leaf, the layer axis of a stacked leaf skipped:
  1. the embedding table shards on the vocab axis only;
  2. Megatron pairing: column-parallel producers (``wq wk wv w_gate w_up
     w_in router``) shard their output axis, row-parallel consumers (``wo
     w_down w_out``) their input axis; any other leaf its largest axis
     divisible by ``|model|``;
  3. with FSDP (``param_count >= FSDP_THRESHOLD_PARAMS``) the largest
     *other* axis divisible by the data-parallel size goes on the dp axes.

**Layouts.**  The reference stacks the blocks on a leading layer axis; the
port keeps ``blocks`` (and ``cross_blocks``) as lists of per-layer dicts,
so a leaf ``…/blocks/<i>/…`` has no layer axis and its spec is the
reference's with the layer entry removed.  Adafactor's block slots are
stacked in the port too (``train/optim.py``), so a ``blocks`` leaf without
a layer index keeps the reference's layer axis.
"""
from __future__ import annotations

import math
import re

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..models.config import ModelConfig
from ..models.layers import batch_axes
from .mesh import axis_sizes, dp_axes, model_size

#: archs whose parameters+optimizer exceed single-chip HBM without FSDP
FSDP_THRESHOLD_PARAMS = 30e9

#: Megatron pairing: column-parallel producers (shard the OUTPUT axis) feed
#: row-parallel consumers (shard the INPUT axis) so each block needs only
#: one all-reduce per projection pair in fwd (+1 in bwd).
_COL_PARALLEL = re.compile(r"/(wq|wk|wv|w_gate|w_up|w_in|router)$")
_ROW_PARALLEL = re.compile(r"/(wo|w_down|w_out)$")
_PER_LAYER = re.compile(r"(^|/)(cross_)?blocks/\d+(/|$)")


def _is_stacked(path: str) -> bool:
    """A ``blocks`` leaf with the reference's leading layer axis (not a
    per-layer leaf of the port's lists)."""
    return "blocks" in path and not _PER_LAYER.search(path)


def leaf_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(path, leaf)] of a dict / list tree in order (a tuple, such as a
    spec, is a leaf); paths join dict keys and list indices with ``/``
    (``params/blocks/3/attn/wq``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaf_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` on every leaf -> a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _stacked_spec(path: str, shape: tuple[int, ...], *, mesh,
                  fsdp: bool, stacked: bool) -> tuple:
    """The reference's ``param_spec`` of a leaf of ``shape``; ``stacked``
    says whether axis 0 is a layer axis."""
    ndim = len(shape)
    start = 1 if stacked and ndim >= 2 else 0
    axes_free = list(range(start, ndim))
    if not axes_free:
        return ()
    msize = model_size(mesh)
    dnames = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    dsize = math.prod(sizes[a] for a in dnames) if dnames else 1
    spec: list = [None] * ndim
    # 1) model axis: Megatron-paired for named projections, else largest
    #    divisible axis.  Embedding tables shard on the vocab axis only.
    m_axis = None
    if path.endswith("table"):
        if msize > 1 and shape[0] % msize == 0:
            spec[0] = "model"
        return tuple(spec)
    if msize > 1 and ndim - start >= 2:
        if _COL_PARALLEL.search(path) and shape[-1] % msize == 0:
            m_axis = ndim - 1
        elif _ROW_PARALLEL.search(path) and shape[-2] % msize == 0:
            m_axis = ndim - 2
    cand = sorted(axes_free, key=lambda a: -shape[a])
    if m_axis is None:
        m_axis = next((a for a in cand if msize > 1
                       and shape[a] % msize == 0 and shape[a] >= msize),
                      None)
    if m_axis is not None:
        spec[m_axis] = "model"
    # 2) fsdp axis over pure-dp mesh axes ("data" or ("pod","data"))
    if fsdp and dnames:
        cand2 = [a for a in cand if a != m_axis]
        d_axis = next((a for a in cand2
                       if shape[a] % dsize == 0 and shape[a] >= dsize), None)
        if d_axis is not None:
            spec[d_axis] = dnames if len(dnames) > 1 else dnames[0]
    return tuple(spec)


def param_spec(path: str, shape: tuple[int, ...], *, mesh,
               fsdp: bool) -> tuple:
    """The spec of one leaf: a per-layer leaf of the port is ruled as the
    reference's stacked leaf, then loses the layer entry."""
    shape = tuple(shape)
    if _PER_LAYER.search(path):
        return _stacked_spec(path, (1, *shape), mesh=mesh, fsdp=fsdp,
                             stacked=True)[1:]
    return _stacked_spec(path, shape, mesh=mesh, fsdp=fsdp,
                         stacked=_is_stacked(path))


def use_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() >= FSDP_THRESHOLD_PARAMS


def param_specs(cfg: ModelConfig, params, mesh):
    """Tree of specs matching a parameter tree (tensors or anything with a
    ``.shape``)."""
    fsdp = use_fsdp(cfg)
    return map_paths(lambda p, v: param_spec(p, tuple(v.shape), mesh=mesh,
                                              fsdp=fsdp), params)


def state_specs(cfg: ModelConfig, state, mesh):
    """Train-state specs: optimizer slots and residuals follow their
    parameter's rule; ``step`` and every ``count`` replicate."""
    fsdp = use_fsdp(cfg)

    def one(path, v):
        if path == "step" or path.endswith("count"):
            return ()
        return param_spec(path, tuple(v.shape), mesh=mesh, fsdp=fsdp)

    return map_paths(one, state)


def batch_axis_spec(batch_size: int, mesh):
    """Spec entry for a global-batch axis: as many dp axes as divide it
    (``models.layers.batch_axes``, which the regions run on local tensors
    use too)."""
    use = batch_axes(mesh, batch_size)
    if not use:
        return None
    return use if len(use) > 1 else use[0]


def batch_specs(batch, mesh):
    """Input-batch specs: axis 0 = global batch, the rest replicated."""
    def one(_path, v):
        shape = tuple(v.shape)
        b = shape[0] if shape else 1
        return (batch_axis_spec(b, mesh), *([None] * (len(shape) - 1)))
    return map_paths(one, batch)


def cache_specs(cfg: ModelConfig, caches, mesh):
    """KV / SSM cache specs of the port's per-layer caches ((B, ...) per
    leaf; the reference's (L, B, ...) without the layer entry):

    * batch axis -> dp axes (if divisible),
    * KV seq axis -> ``model`` (flash-decode style) — every head count,
    * SSM head axis -> ``model`` if divisible."""
    del cfg
    msize = model_size(mesh)

    def one(path, v):
        shape = tuple(v.shape)
        spec: list = [None] * len(shape)
        if len(shape) >= 1:
            spec[0] = batch_axis_spec(shape[0], mesh)
        if re.search(r"/(k|v|pos)$", path) and len(shape) >= 2:
            if msize > 1 and shape[1] % msize == 0:
                spec[1] = "model"                          # cache seq axis
        elif path.endswith("state") and len(shape) >= 2:
            if msize > 1 and shape[1] % msize == 0:
                spec[1] = "model"                          # ssm heads
        return tuple(spec)

    return map_paths(one, caches)


def to_placements(spec: tuple, mesh) -> list:
    """A spec -> one DTensor placement per mesh axis: ``Shard(d)`` on each
    axis named at tensor dim ``d`` (a tuple entry shards that dim over each
    of its axes, the first outermost, as the reference's), else
    ``Replicate()``.  An axis of size 1 gets ``Replicate()`` either way:
    it holds the same local tensor, and DTensor refuses some views of a
    dimension sharded on it (a one-row microbatch folded for a product)."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    used: set = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in used:
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            used.add(a)
            i = names.index(a)
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return out


def distribute_tree(tree, specs, mesh, *, src_data_rank: int | None = 0):
    """Every tensor of ``tree`` placed on ``mesh`` by its spec in ``specs``
    (a tree of the same structure) -> a tree of DTensors.  Each rank holds
    the full tensor; ``src_data_rank=0`` takes rank 0's values, ``None``
    each rank's own (no communication)."""
    spec_at = dict(leaf_paths(specs))

    def one(path, t):
        return distribute_tensor(t, mesh, to_placements(spec_at[path], mesh),
                                 src_data_rank=src_data_rank)

    return map_paths(one, tree)
