"""Mamba2 (SSD, state-space duality) blocks of the port
(``repro.models.ssm``): the chunked scan for prefill and training, the
recurrent step for decode.

Input projection to (z, x, B, C, dt), a causal depthwise conv on (x, B, C),
one scalar decay ``A = -exp(a_log)`` per head, the SSD over chunks (the
quadratic dual form within a chunk, the state recurrence between chunks),
a gated RMSNorm and the output projection.  Shapes: ``d_inner = expand ·
d_model`` (or ``ssm_n_heads · ssm_head_dim``), ``nh = d_inner /
ssm_head_dim`` heads, state ``N = ssm_state``, ``G = ssm_groups`` groups of
B and C (each ``N`` wide; head ``h`` reads group ``h // (nh / G)``), and
the gated RMSNorm taken over each of ``G`` equal slices of ``d_inner``
(Mamba-2's grouped norm; one slice for ``G = 1``).

Which path runs where (:func:`_mixer`): decode (a cache, S == 1, no
``"rows"``) is the recurrent step, :func:`..kernels.ssd.ssd_step`, which a
CUDA graph captures; every other call (training, a forward without a cache,
a prefill into a cache) is the chunked path, :func:`..kernels.ssd.ssd_mixer`.
Each runs the hand-written kernels (``kernels/csrc/ssd.cu``: the chunked
path's conv, float32 SSD and gated norm in five launches; the step's conv,
float32 state update and gated norm in three) for a CUDA tensor where
autograd does not record — serving's prefills and decode steps, ``forward``
under ``no_grad`` or on weights that need no gradient, the sharded mixer's
local call under ``no_grad`` — and the plain version (the same functions in
PyTorch operations) on the CPU and wherever autograd records (training: the
kernels have no backward).  Nothing else chooses: no option, environment
variable or config field.

While a profile records (:mod:`repro_torch.trace`), each chunked call runs
inside an ``ssm.scan`` span (conv, SSD and gated norm, whichever path) and
counts one ``ssm.scan_kernel`` or one ``ssm.scan_plain`` in the open root's
record; each recurrent step counts one ``ssm.step_kernel`` or one
``ssm.step_plain`` and opens no span (a CUDA graph's replay counts what its
capture did: :class:`..serve.graph.DecodeGraph`).

The reference's float32 sections are kept: the SSD and the recurrent step
run in float32 on float32 copies of x, B, C and dt; the conv, the gate and
the projections at the compute type.  In the plain version, its 3- and
4-operand einsums are written as pairwise products that build no
``(…, Q, N, HD)`` intermediate, and its ``lax.scan`` over chunks is a loop
that emits the previous state.  With a cache, the new state and conv window
are written into the cache in place, as the port's KV caches are.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..kernels import ssd
from .config import ModelConfig
from .layers import (_dt, batch_placements, dense_init, local_call,
                     row_partial)

A_INIT_RANGE = (1.0, 16.0)


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The reference's distributions: dense N(0, 1/in), conv N(0, 1/kw),
    ``a_log = log(linspace(1, 16, nh))``, ``dt_bias`` the inverse softplus
    of a log-uniform draw in [1e-3, 1e-1], ``d_skip`` ones."""
    dt = _dt(cfg, "param")
    dev = gen.device
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gs = cfg.ssm_groups * cfg.ssm_state
    conv_dim = di + 2 * gs
    lo, hi = math.log(1e-3), math.log(1e-1)
    p = {
        # fused input projection: z, x, B, C, dt
        "w_in": dense_init(gen, d, 2 * di + 2 * gs + nh, dt),
        "conv_w": (torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                               device=dev)
                   / math.sqrt(cfg.ssm_conv)).to(dt),
        # a pattern model draws its conv bias N(0, 1/kw), so that the
        # bias is exercised (the published checkpoints carry one)
        "conv_b": (torch.randn((conv_dim,), generator=gen, device=dev)
                   / math.sqrt(cfg.ssm_conv)).to(dt) if cfg.layer_pattern
        else torch.zeros((conv_dim,), dtype=dt, device=dev),
        "a_log": torch.log(torch.linspace(*A_INIT_RANGE, nh, device=dev)),
        "dt_bias": torch.log(torch.expm1(torch.exp(
            torch.rand((nh,), generator=gen, device=dev) * (hi - lo) + lo))),
        "d_skip": torch.ones((nh,), device=dev),
        "norm": {"scale": torch.ones((di,), dtype=dt, device=dev)},
        "w_out": dense_init(gen, di, d, dt),
    }
    return p


def apply_ssm(p: dict, cfg: ModelConfig, u: torch.Tensor, *,
              ssm_cache: dict | None = None,
              valid: torch.Tensor | None = None,
              ) -> tuple[torch.Tensor, dict | None]:
    """u: (B, S, D) -> (out, cache).

    Prefill and training run the chunked SSD; decode (``ssm_cache`` given,
    S == 1, no ``"rows"``) the O(1) recurrent step.  ``valid``: an
    optional (B, S) mask of a right-padded prefill — padded steps neither
    decay nor write the state (dt forced to 0) and the conv window kept is
    the last ``kw − 1`` valid inputs.  The cache, ``{"state": (B, NH, N,
    HD) float32, "conv": (B, kw − 1, conv_dim)}``, is **updated in place**
    and returned (a prefill shorter than ``kw − 1`` keeps the old conv
    window, as the reference); with ``"rows"`` (B,) in it, a prefill
    writes those batch rows of a larger cache."""
    cdt = _dt(cfg, "compute")
    proj = u @ p["w_in"].to(cdt)                          # (B,S,2di+2ds+nh)
    if isinstance(proj, DTensor) and ssm_cache is None:
        yn = _mixer_sharded(p, cfg, proj, valid)
    else:
        yn = _mixer(p, cfg, proj, ssm_cache, valid)
    return yn @ p["w_out"].to(cdt), ssm_cache


def _mixer_sharded(p: dict, cfg: ModelConfig, proj: DTensor, valid):
    """:func:`_mixer` on a mesh, without a cache (training, a prefill):
    on each rank's batch rows, the projection's columns and the mixer's
    small parameters gathered (their gradients a ``Partial`` sum over the
    ranks that split the rows).  Run as DTensor ops, the SSD's 5-axis
    intermediates made DTensor's redistribution planner the step's largest
    cost (16 of 25 s for mamba2's smoke config on a fake (4, 2) mesh), and
    a view of the split projection failed DTensor's propagation in torch
    2.11; the chunk recurrence is per sequence, so each rank's rows are
    independent."""
    mesh = proj.device_mesh
    rows = batch_placements(mesh, proj.shape[0])
    full = [Replicate()] * mesh.ndim
    leaves = [p[k] for k in ssd.KEYS] + [p["norm"]["scale"]]

    def region(proj, valid, *leaves):
        q = dict(zip(ssd.KEYS, leaves[:-1], strict=True))
        q["norm"] = {"scale": leaves[-1]}
        return _mixer(q, cfg, proj, None, valid)

    return local_call(region, (proj, valid, *leaves),
                      (rows, None if valid is None else rows,
                       *[full] * len(leaves)), rows,
                      grad_placements=(None, None, *[row_partial(rows)]
                                       * len(leaves)))


def _mixer(p: dict, cfg: ModelConfig, proj: torch.Tensor,
           ssm_cache: dict | None, valid: torch.Tensor | None
           ) -> torch.Tensor:
    """The block between its projections: (B, S, 2di + 2ds + nh) -> the
    gated-normed (B, S, di); the cache, if any, written in place.  A
    prefill or training call (no cache, S > 1, or ``"rows"``) is the
    chunked path of :mod:`..kernels.ssd`; decode its recurrent step."""
    rows = None if ssm_cache is None else ssm_cache.get("rows")
    if ssm_cache is None or proj.shape[1] > 1 or rows is not None:
        return ssd.ssd_mixer(p, cfg, proj, ssm_cache, valid)
    return ssd.ssd_step(p, cfg, proj, ssm_cache, valid)


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """A zero state (float32) and conv window (the compute type)."""
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             cfg.d_inner + 2 * cfg.ssm_groups
                             * cfg.ssm_state),
                            dtype=_dt(cfg, "compute"), device=device),
    }
