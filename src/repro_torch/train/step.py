"""Train and eval steps of the port (``repro.train.step``): microbatched
accumulation, int8 error-feedback compression, clipping, the cosine
learning rate and the optimizer.

``build_train_step(cfg, tc)`` returns

    train_step(state, batch) -> (state, metrics)

with ``state = {"params", "opt", "ef"?, "step"}`` updated **in place** (the
same dict comes back): at 4·10⁹ parameters the reference's functional new
state would not fit beside the old.  ``batch`` holds numpy arrays (or
tensors) ``{"tokens", "labels", "loss_mask"?}``; the step moves them to the
parameters' device.  The global batch is split into ``tc.n_microbatches``
row blocks whose gradients are summed into float32 buffers, then divided
by the count (the reference's ``lax.scan``); with one microbatch the
gradients keep the parameters' type.  Then, in the reference's order:
compression (``grad_compression="int8_ef"``), clipping by the global norm,
``cosine_lr(step)`` and the optimizer, each in place one leaf at a time.
Metrics are 0-d tensors on the device: loss, accuracy, tokens, grad_norm,
lr.

**On a mesh** the state and the batch are DTensors placed by
``launch/sharding.py`` (the launcher distributes them) and the same step
runs under ``implicit_replication`` (a plain tensor made inside the model,
such as the positions, counts as replicated).  Every buffer it makes
(``zeros_like``) keeps its parameter's placements, and the norm, the int8
scale and the metrics are the global ones: DTensor reduces a ``Partial``
sum or max by an all-reduce.  Microbatch ``i`` is the reference's row
block ``[i·b/n, (i+1)·b/n)`` of the global batch: each batch leaf is
all-gathered once (``b × s`` integers: no parameter traffic) and the block
re-split over the data-parallel ranks by the leaf's placements.  Metrics
come back replicated.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ..core.simulator import resolve_device
from ..models import transformer as T
from ..models.config import ModelConfig, TrainConfig
from . import compress as C
from . import optim as O


def init_state(gen: torch.Generator, cfg: ModelConfig, tc: TrainConfig,
               device="cuda") -> dict:
    """A fresh train state on ``device``: parameters drawn from ``gen``
    (which must live there), zero optimizer state, zero residuals with
    ``int8_ef``, step 0."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator lives on {gen.device}, the state "
                         f"is wanted on {dev}")
    params = T.init_params(gen, cfg)
    opt_init, _ = O.make_optimizer(cfg.optimizer)
    # a 0-d tensor made from a Python int: under FakeTensorMode (the
    # dry-run) it keeps its value, so ``int(step)`` still reads it
    state = {"params": params, "opt": opt_init(params),
             "step": torch.tensor(0, dtype=torch.int32, device=dev)}
    if tc.grad_compression == "int8_ef":
        state["ef"] = C.ef_init(params)
    return state


def _device_batch(batch: dict, device: torch.device) -> dict:
    """numpy arrays to tensors on ``device``; DTensors stay where they
    are."""
    return {k: v if isinstance(v, DTensor) else
            (torch.from_numpy(np.array(v, order="C"))
             if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _rows(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo:hi`` of a batch leaf; a DTensor's are gathered, cut and
    placed as the leaf (no sharding rule cuts a sharded axis in place)."""
    if not isinstance(v, DTensor):
        return v[lo:hi]
    return distribute_tensor(v.full_tensor()[lo:hi], v.device_mesh,
                             v.placements, src_data_rank=None)


def _global(v):
    """A metric as a plain tensor: a DTensor's full (replicated) value."""
    return v.full_tensor() if isinstance(v, DTensor) else v


def _grads(params, leaves, cfg: ModelConfig, batch: dict):
    """-> (gradients of the mean loss in the leaves' order, metrics)."""
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, metrics = T.loss_fn(params, cfg, batch)
        # a leaf the loss does not reach (the token embedding of a model
        # fed ``input_embeds``) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return list(grads), metrics


def accumulate_grads(params, cfg: ModelConfig, tc: TrainConfig,
                     batch: dict) -> tuple[list, dict]:
    """The gradient a train step applies, before compression and clipping:
    -> (gradients in the order of ``tree_leaves(params)``, metrics).  One
    microbatch: the loss's gradients in the parameters' type; ``n`` of
    them: the float32 mean of their gradients, the metrics averaged
    (tokens summed), as the reference's scan."""
    leaves = O.tree_leaves(params)
    batch = _device_batch(batch, leaves[0].device)
    n = tc.n_microbatches
    if n == 1:
        return _grads(params, leaves, cfg, batch)
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by {n} microbatches")
    per = b // n
    grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    metrics = None
    for i in range(n):
        mb = {k: _rows(v, i * per, (i + 1) * per) for k, v in batch.items()}
        g, m = _grads(params, leaves, cfg, mb)
        with torch.no_grad():
            for acc, x in zip(grads, g, strict=True):
                acc.add_(x.to(torch.float32))
        metrics = m if metrics is None else {k: metrics[k] + m[k]
                                             for k in metrics}
        del g
    with torch.no_grad():
        for acc in grads:
            acc.div_(n)
    metrics = {k: v / n for k, v in metrics.items()}
    metrics["tokens"] = metrics["tokens"] * n
    return grads, metrics


def apply_update(state: dict, grads: list, cfg: ModelConfig,
                 tc: TrainConfig) -> tuple[torch.Tensor, float]:
    """The rest of a train step, in place on ``state`` (``grads`` as
    :func:`accumulate_grads` gives them, consumed): compression with
    ``int8_ef``, clipping, ``cosine_lr(step)``, the optimizer, ``step +=
    1``.  -> (the global norm before clipping, the learning rate)."""
    params = state["params"]
    if tc.grad_compression == "int8_ef":
        grads = C.tree_compress_decompress_(grads, state["ef"], params)
    elif tc.grad_compression != "none":
        raise ValueError(f"unknown grad_compression {tc.grad_compression!r}")
    gnorm = O.clip_by_global_norm_(grads, tc.grad_clip)
    lr = O.cosine_lr(int(_global(state["step"])), base_lr=tc.learning_rate,
                     warmup=tc.warmup_steps, total=tc.total_steps)
    _, opt_update = O.make_optimizer(cfg.optimizer)
    if cfg.optimizer == "adamw":
        opt_update(grads, state["opt"], params, lr=lr, beta1=tc.beta1,
                   beta2=tc.beta2, eps=tc.eps, weight_decay=tc.weight_decay)
    else:
        opt_update(grads, state["opt"], params, lr=lr,
                   weight_decay=tc.weight_decay)
    state["step"] += 1
    return gnorm, lr


def build_train_step(cfg: ModelConfig, tc: TrainConfig):
    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        with implicit_replication():
            grads, metrics = accumulate_grads(state["params"], cfg, tc,
                                              batch)
            gnorm, lr = apply_update(state, grads, cfg, tc)
            del grads
            metrics = {k: _global(v) for k, v in metrics.items()}
        metrics["grad_norm"] = _global(gnorm)
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        return state, metrics

    return train_step


def build_eval_step(cfg: ModelConfig):
    """-> eval_step(params, batch) -> metrics, without gradients."""

    def eval_step(params, batch: dict) -> dict:
        dev = O.tree_leaves(params)[0].device
        with torch.no_grad(), implicit_replication():
            _loss, metrics = T.loss_fn(params, cfg, _device_batch(batch, dev))
            return {k: _global(v) for k, v in metrics.items()}

    return eval_step
