"""The port's cost tools (``repro_torch.launch.dispatch_cost``,
``repro_torch.launch.roofline``), mirroring ``tests/test_roofline.py``:
exact product counts, loops and remat recompute counted as they run, the
collective counter on a fake mesh, the H100 roofline terms — and the
dot FLOPs of a whole train step against the reference's ``jaxpr_cost``,
at the smoke config and at full width (train_4k), both sides abstract.

The reference is taken with ``fused_attention=True``: every attention of
the port runs the fused region (``models/config.py``), whose backward
recomputes the scores from ``out`` and ``lse`` — one product more per
layer than the autodiff of the reference's unfused path, which keeps them.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.checkpoint import checkpoint

from repro.configs import get_config as ref_config
from repro.launch import jaxpr_cost as JC
from repro.models.config import TrainConfig as RTC
from repro.train import step as RTS
from repro_torch.configs import get_config
from repro_torch.launch import dispatch_cost as DC
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RL
from repro_torch.models.config import SHAPES, TrainConfig
from repro_torch.train import step as TS

#: the reference dry-run's microbatches for train_4k (repro.launch.dryrun,
#: which is not imported here: it sets XLA_FLAGS for 512 devices)
MICROBATCHES = {"qwen3-4b": 2, "mamba2-780m": 1, "qwen2-moe-a2.7b": 2}


def test_matmul_counted_exactly():
    c = DC.dispatch_cost(lambda a, b: a @ b, torch.empty(64, 128),
                         torch.empty(128, 32))
    assert c["flops"] == 2 * 64 * 128 * 32 == c["dot_flops"]


def test_a_python_loop_is_counted_per_iteration():
    def f(x):
        for _ in range(7):
            x = x @ x
        return x
    c = DC.dispatch_cost(f, torch.empty(16, 16))
    assert c["dot_flops"] == 7 * 2 * 16 ** 3
    assert 7 * 2 * 16 ** 3 <= c["flops"] < 7.5 * 2 * 16 ** 3


def test_remat_recompute_is_counted():
    def g(x):
        return ((x @ x) ** 2).sum()

    def grad(fn):
        def f(x):
            x = x.detach().requires_grad_(True)
            return torch.autograd.grad(fn(x), x)[0]
        return f

    plain = DC.dispatch_cost(grad(g), torch.empty(32, 32))
    remat = DC.dispatch_cost(
        grad(lambda x: checkpoint(g, x, use_reentrant=False)),
        torch.empty(32, 32))
    assert remat["dot_flops"] == plain["dot_flops"] + 2 * 32 ** 3
    assert remat["flops"] > plain["flops"]


def test_bytes_major_below_upper():
    c = DC.dispatch_cost(lambda a, b: torch.tanh(a @ b) * 2.0 + 1.0,
                         torch.empty(64, 64), torch.empty(64, 64))
    assert 0 < c["bytes_major"] <= c["bytes_upper"]
    assert c["top_flop_prims"]["mm"] == 2 * 64 ** 3
    assert "mm:64x64" in c["top_byte_ops"]


def test_collective_counter_on_a_fake_mesh():
    """One row-parallel product on a (4, 2) mesh: one all-reduce of the
    local (2, 32) float32 output; twelve in a loop: twelve."""
    with M.fake_group(8):
        mesh = M.make_host_mesh(model=2, device="cpu")
        x = distribute_tensor(torch.randn(8, 64), mesh, [Shard(0), Shard(1)])
        w = distribute_tensor(torch.randn(64, 32), mesh,
                              [Replicate(), Shard(0)])

        def row_parallel():
            return (x @ w).redistribute(mesh, [Shard(0), Replicate()])

        _out, one = RL.collective_bytes(row_parallel)
        _out, twelve = RL.collective_bytes(
            lambda: [row_parallel() for _ in range(12)])
    assert one["counts"]["all-reduce"] == 1
    assert one["bytes"]["all-reduce"] == one["total_bytes"] == 2 * 32 * 4
    assert twelve["counts"]["all-reduce"] == 12
    assert twelve["total_bytes"] == 12 * one["total_bytes"]


def test_roofline_terms_use_the_h100_data_sheet():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    cfg = get_config("mamba2-780m")
    record = {"dispatch_cost": {"flops": 1e15, "bytes_major": 1e12},
              "collectives": {"total_bytes": 1e9}}
    t = RL.roofline_terms(record, cfg, SHAPES["train_4k"], 256)
    assert t["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert t["compute_s"] == pytest.approx(1e15 / 256 / RL.PEAK_FLOPS)
    assert t["memory_s"] == pytest.approx(1e12 / 256 / RL.HBM_BW)
    assert t["collective_s"] == pytest.approx(1e9 / RL.LINK_BW)
    assert t["roofline_fraction"] > 0
    mf = 6.0 * cfg.active_param_count() * 256 * 4096
    assert t["model_flops"] == mf
    assert RL.mfu(cfg, SHAPES["train_4k"], 2.0, 256) == pytest.approx(
        mf / 2.0 / 256 / RL.PEAK_FLOPS)


def _dot_flops(arch: str, full: bool) -> tuple[float, float]:
    """(reference ``dot_general`` FLOPs, port product FLOPs) of one train
    step: train_4k's global batch and microbatches at full width, a (4,
    32)-token batch in 2 microbatches at the smoke config."""
    rcfg = ref_config(arch).replace(fused_attention=True)
    cfg = get_config(arch)
    if full:
        b, s, n = 256, 4096, MICROBATCHES[arch]
    else:
        rcfg, cfg, (b, s, n) = rcfg.smoke(), cfg.smoke(), (4, 32, 2)
    tc = RTC(n_microbatches=n)
    state = jax.eval_shape(lambda k: RTS.init_state(k, rcfg, tc),
                           jax.random.PRNGKey(0))
    batch = {k: jax.ShapeDtypeStruct((b, s), dt) for k, dt in (
        ("tokens", jnp.int32), ("labels", jnp.int32),
        ("loss_mask", jnp.float32))}
    ref = JC.jaxpr_cost(RTS.build_train_step(rcfg, tc), state, batch)
    with FakeTensorMode():
        tstate = TS.init_state(torch.Generator().manual_seed(0), cfg,
                               TrainConfig(n_microbatches=n), "cpu")
        tbatch = {"tokens": torch.zeros((b, s), dtype=torch.int32),
                  "labels": torch.zeros((b, s), dtype=torch.int32),
                  "loss_mask": torch.ones((b, s))}
        port = DC.dispatch_cost(
            TS.build_train_step(cfg, TrainConfig(n_microbatches=n)),
            tstate, tbatch, fake=False)
    return ref["top_flop_prims"]["dot_general"], port["dot_flops"]


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "train_4k"])
@pytest.mark.parametrize("arch", list(MICROBATCHES))
def test_dot_flops_match_the_reference_jaxpr_cost(arch, full):
    ref, port = _dot_flops(arch, full)
    assert abs(port - ref) <= 0.01 * ref, (port, ref, port / ref)
