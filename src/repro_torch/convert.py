"""Carry chip state across from the reference simulator.

The system holds no weights; what it carries is the state of a simulated
bank.  :func:`numpy_bank_state` reads the plain numpy/int state of a
reference ``repro.core.simulator.BankSim`` (by attribute, without importing
the reference), and :func:`bank_state_from_numpy` rebuilds it as a port
:class:`~repro_torch.core.simulator.BankSim` on a device — so one episode
can be forked into both packages mid-stream and continued in each.

The PuD engine holds no state to carry: a packed bit-plane of the reference
(uint32 words) crosses over as
``torch.from_numpy(np.asarray(p).view(np.int32))`` — the port's planes are
int32 bit patterns (``repro_torch.pud.engine.as_planes`` does this).

The binary linear layers do hold weights: :func:`binary_linear_from_numpy`
turns the reference's ``{"w": (out, in)}`` parameters, as numpy arrays,
into the port's :class:`~repro_torch.models.quant.BinaryLinear`;
:func:`lm_params_from_numpy` turns the reference decoder's parameter tree
into the port's, so both compute the same model; and
:func:`train_state_from_numpy` turns the reference's whole train state
(parameters, AdamW moments or Adafactor slots, error-feedback residuals,
step) into the port's, so both train from the same state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.analog import AnalogParams
from .core.simulator import BankSim, resolve_device
from .models.config import ModelConfig, TrainConfig
from .models.quant import BinaryLinear
from .models.transformer import STACKED, n_cross_blocks
from .train.optim import tree_leaves

#: constructor settings of the bank, then its mutable state
SETTINGS = ("module", "row_bits", "trials", "error_model", "temp_c",
            "track_unshared", "rowclone_fail_p", "seed", "noise_seed",
            "bank", "params")
STATE = ("_subarrays", "_rowmap", "_nrows", "_static", "_trial")


def numpy_bank_state(sim) -> dict:
    """The plain state of a reference-style bank simulator: settings as
    Python values (``module`` by name, ``params`` as a dict), cell buffers,
    slot maps, static latents and the command counter as numpy/ints."""
    state = {k: getattr(sim, k) for k in SETTINGS + STATE
             if k not in ("module", "row_bits", "params")}
    state["module"] = sim.module.name
    state["row_bits"] = sim.geom.row_bits
    state["params"] = dataclasses.asdict(sim.params)
    return state


def bank_state_from_numpy(state: dict, device: str | torch.device, *,
                          draws: str = "numpy") -> BankSim:
    """A port ``BankSim`` on ``device`` holding ``state`` (as produced by
    :func:`numpy_bank_state`); ``draws="numpy"`` continues the reference's
    per-command noise streams draw for draw."""
    missing = [k for k in SETTINGS + STATE if k not in state]
    if missing:
        raise KeyError(f"bank state lacks {missing}")
    sim = BankSim(state["module"], row_bits=state["row_bits"],
                  seed=state["seed"], params=AnalogParams(**state["params"]),
                  temp_c=state["temp_c"], error_model=state["error_model"],
                  trials=state["trials"],
                  track_unshared=state["track_unshared"],
                  noise_seed=state["noise_seed"],
                  rowclone_fail_p=state["rowclone_fail_p"],
                  bank=state["bank"], draws=draws, device=device)
    sim._subarrays = {int(s): torch.from_numpy(np.array(a, np.float32))
                      .to(sim.device)
                      for s, a in state["_subarrays"].items()}
    sim._rowmap = {int(s): np.array(m, np.int64)
                   for s, m in state["_rowmap"].items()}
    sim._nrows = {int(s): int(n) for s, n in state["_nrows"].items()}
    sim._static = {int(s): (np.array(a), np.array(b))
                   for s, (a, b) in state["_static"].items()}
    sim._trial = int(state["_trial"])
    return sim


def binary_linear_from_numpy(p: dict,
                             device: str | torch.device = "cuda"
                             ) -> BinaryLinear:
    """The port's :class:`BinaryLinear` on ``device`` holding the weights of
    a reference binary linear layer: ``p["w"]`` is its (out, in) weight as
    a numpy array (``np.asarray`` of the reference's parameter)."""
    w = np.asarray(p["w"], dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"want an (out, in) weight, got shape {w.shape}")
    dev = resolve_device(device)
    layer = BinaryLinear(w.shape[1], w.shape[0], device=dev)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
    return layer


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor on ``device``; bfloat16
    arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    cross over bit for bit as int16."""
    a = np.array(a, order="C")          # a copy: no view of the caller's
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(params: dict, cfg: ModelConfig,
                         device: str | torch.device = "cuda") -> dict:
    """The port's decoder parameters on ``device`` from the reference's
    ``repro.models.transformer.init_params`` tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``).  The reference stacks the
    blocks (and a VLM's cross blocks) on a leading layer axis (it
    initialises them with ``vmap``); the port keeps one dict per layer.
    Every subtree of a block comes along (attention, MoE with its (E, in,
    out) expert weights, SSM, the hybrid's output norms).  Dense weights
    are ``(in, out)`` in both, so nothing is transposed."""
    dev = resolve_device(device)
    conv = _map(lambda a: _tensor(a, dev),
                {k: v for k, v in params.items() if k not in STACKED})
    for key in STACKED:
        if key in params:
            conv[key] = _unstack(params[key], dev)
    n_cross = n_cross_blocks(cfg)
    want = {"blocks": cfg.n_layers - n_cross, "cross_blocks": n_cross}
    for key, n in want.items():
        if len(conv.get(key, ())) != n:
            raise ValueError(f"the tree holds {len(conv.get(key, ()))} "
                             f"{key}, the config {n}")
    return conv


def _unstack(tree: dict, dev: torch.device) -> list[dict]:
    stacked = _map(np.asarray, tree)
    return [_map(lambda a, i=i: _tensor(a[i], dev), stacked)
            for i in range(len(tree_leaves(stacked)[0]))]


def train_state_from_numpy(state: dict, cfg: ModelConfig, tc: TrainConfig,
                           device: str | torch.device = "cuda") -> dict:
    """The port's train state on ``device`` from the reference's
    ``repro.train.step.init_state`` state (or one it stepped) as numpy
    arrays (``jax.tree.map(np.asarray, state)``): ``params``, ``opt``
    (AdamW ``m`` / ``v`` / ``count``, or Adafactor ``slots`` / ``count``),
    ``ef`` (with ``grad_compression="int8_ef"``) and ``step``.  Trees shaped
    as the parameters (params, ``m``, ``v``, ``ef``) are unstacked per layer
    as :func:`lm_params_from_numpy` does; Adafactor's slots keep the
    reference's layout, stacked blocks included (``repro_torch.train.
    optim.adafactor_init``)."""
    dev = resolve_device(device)
    like = lambda tree: lm_params_from_numpy(tree, cfg, dev)  # noqa: E731
    opt = state["opt"]
    if cfg.optimizer == "adamw":
        new_opt = {"m": like(opt["m"]), "v": like(opt["v"])}
    elif cfg.optimizer == "adafactor":
        new_opt = {"slots": _map(lambda a: _tensor(a, dev), opt["slots"])}
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    new_opt["count"] = _tensor(opt["count"], dev)
    out = {"params": like(state["params"]), "opt": new_opt,
           "step": _tensor(state["step"], dev)}
    if tc.grad_compression == "int8_ef":
        out["ef"] = like(state["ef"])
    return out
