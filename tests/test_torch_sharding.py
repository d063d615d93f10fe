"""The port's mesh helpers and sharding rules (``repro_torch.launch.mesh``,
``repro_torch.launch.sharding``) against the reference's
(``repro.launch.sharding``).

For every arch at full width, on the (16, 16), (2, 16, 16) and (4, 2)
meshes, the port's parameter / state / batch / cache specs equal the
reference's with the layer axis removed: the reference stacks the blocks
on a leading layer axis, the port keeps a list of per-layer dicts
(``params/blocks/3/attn/wq`` <-> ``params/blocks/attn/wq``).  Shapes only:
``jax.eval_shape`` on an ``AbstractMesh`` for the reference, fake tensors
and a fake-process-group ``DeviceMesh`` for the port; nothing allocated.
"""
import math
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

import repro_torch
from repro.configs import get_config as ref_config
from repro.launch import sharding as RS
from repro.models import transformer as RT
from repro.models.config import SHAPES, TrainConfig as RTC
from repro.train import step as RTS
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.config import TrainConfig
from repro_torch.train import step as TS

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
_LAYER = re.compile(r"(^|/)((?:cross_)?blocks)/\d+(?=/|$)|^\d+/")


def _unlayer(path: str) -> str:
    """A port path without its layer index (``params/blocks/3/attn/wq``
    -> ``params/blocks/attn/wq``; a cache's ``3/kv/k`` -> ``kv/k``)."""
    return _LAYER.sub(lambda m: (m.group(1) or "") + (m.group(2) or ""),
                      path)


def _ref_leaves(tree, specs) -> dict[str, tuple]:
    """{path: spec tuple} of a reference spec tree (paths as the port's,
    without layer indices)."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {RS._leaf_path(p): tuple(s) for p, s in flat}


def _port_leaves(specs) -> dict[str, list[tuple]]:
    """{reference path: [spec of each layer]} of a port spec tree."""
    out: dict[str, list[tuple]] = {}
    for path, spec in SH.leaf_paths(specs):
        out.setdefault(_unlayer(path), []).append(spec)
    return out


def _assert_equal(port_specs, ref_specs, ref_tree, port_tree):
    """Every port leaf's spec == the reference leaf's, its layer entry
    removed where the port holds one layer (a per-layer leaf)."""
    ref = _ref_leaves(ref_tree, ref_specs)
    port = _port_leaves(port_specs)
    per_layer = {_unlayer(p) for p, _ in SH.leaf_paths(port_tree)
                 if _LAYER.search(p)}
    assert set(port) == set(ref), set(port) ^ set(ref)
    for path, specs in port.items():
        want = ref[path][1:] if path in per_layer else ref[path]
        assert all(s == want for s in specs), (path, specs[0], ref[path])


def _trees(arch: str):
    """(reference shapes, port fake tensors) of the train state, the
    parameters, the caches and the batches of every kind."""
    rcfg, cfg = ref_config(arch), get_config(arch)
    key = jax.random.PRNGKey(0)
    rstate = jax.eval_shape(lambda k: RTS.init_state(k, rcfg, RTC()), key)
    dec = SHAPES["decode_32k"]
    rcache = jax.eval_shape(lambda: RT.init_caches(
        rcfg, dec.global_batch, dec.seq_len, dtype=jnp.bfloat16))
    with FakeTensorMode():
        gen = torch.Generator().manual_seed(0)
        state = TS.init_state(gen, cfg, TrainConfig(), "cpu")
        cache = T.init_caches(cfg, dec.global_batch, dec.seq_len,
                              device="cpu")
    batches = {}
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        sh = SHAPES[name]
        s = 1 if sh.kind == "decode" else sh.seq_len
        batches[name] = (
            {"tokens": jax.ShapeDtypeStruct((sh.global_batch, s), jnp.int32),
             "img": jax.ShapeDtypeStruct((sh.global_batch, 8, 16),
                                         jnp.bfloat16)},
            {"tokens": torch.empty((sh.global_batch, s), dtype=torch.int32,
                                   device="meta"),
             "img": torch.empty((sh.global_batch, 8, 16),
                                dtype=torch.bfloat16, device="meta")})
    return rcfg, cfg, rstate, state, rcache, cache, batches


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference_without_the_layer_axis(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    rcfg, cfg, rstate, state, rcache, cache, batches = _trees(arch)
    rmesh = AbstractMesh(shape, names)
    with M.fake_group(math.prod(shape)):
        mesh = M.make_mesh(shape, names, "cpu")
        _assert_equal(SH.param_specs(cfg, state["params"], mesh),
                      RS.param_specs(rcfg, rstate["params"], rmesh),
                      rstate["params"], state["params"])
        _assert_equal(SH.state_specs(cfg, state, mesh),
                      RS.state_specs(rcfg, rstate, rmesh), rstate, state)
        _assert_equal(SH.cache_specs(cfg, cache, mesh),
                      RS.cache_specs(rcfg, rcache, rmesh), rcache, cache)
        for rb, b in batches.values():
            _assert_equal(SH.batch_specs(b, mesh),
                          RS.batch_specs(rb, rmesh), rb, b)
        assert SH.use_fsdp(cfg) == RS.use_fsdp(rcfg)


def test_production_and_host_meshes():
    with M.fake_group(512):
        m = M.make_production_mesh(multi_pod=True, device="cpu")
        assert m.mesh_dim_names == ("pod", "data", "model")
        assert tuple(m.shape) == (2, 16, 16)
        assert M.dp_axes(m) == ("pod", "data")
        assert (M.dp_size(m), M.model_size(m)) == (32, 16)
    with M.fake_group(256):
        m = M.make_production_mesh(device="cpu")
        assert (m.mesh_dim_names, tuple(m.shape)) == (("data", "model"),
                                                      (16, 16))
    with M.fake_group(8):
        m = M.make_host_mesh(model=2, device="cpu")
        assert (tuple(m.shape), M.dp_size(m), M.model_size(m)) == \
            ((4, 2), 4, 2)
        assert tuple(M.make_host_mesh(device="cpu").shape) == (8, 1)
        with pytest.raises(ValueError):
            M.make_host_mesh(model=3, device="cpu")
        with pytest.raises(RuntimeError):
            with M.fake_group(8):
                pass


def test_to_placements_and_distribute_tree():
    with M.fake_group(512):
        m = M.make_production_mesh(multi_pod=True, device="cpu")
        assert SH.to_placements((("pod", "data"), None, "model"), m) == \
            [Shard(0), Shard(0), Shard(2)]
        assert SH.to_placements((None, "model"), m) == \
            [Replicate(), Replicate(), Shard(1)]
        assert SH.to_placements((), m) == [Replicate()] * 3
        with pytest.raises(ValueError):
            SH.to_placements(("model", "model"), m)
    with M.fake_group(8):
        m = M.make_host_mesh(model=2, device="cpu")
        tree = {"a": torch.arange(64.0).reshape(8, 8),
                "b": [torch.ones(3)]}
        d = SH.distribute_tree(tree, {"a": ("data", "model"), "b": [()]},
                               m, src_data_rank=None)
        assert d["a"].placements == (Shard(0), Shard(1))
        assert torch.equal(d["a"].to_local(), tree["a"][:2, :4])
        assert d["b"][0].placements == (Replicate(), Replicate())


def test_stacked_and_per_layer_leaves():
    """A per-layer leaf is ruled as the reference's stacked leaf, then
    loses the layer entry; Adafactor's stacked slots keep it."""
    with M.fake_group(256):
        m = M.make_production_mesh(device="cpu")
        assert SH.param_spec("params/blocks/3/attn/wq", (2560, 4096),
                             mesh=m, fsdp=False) == (None, "model")
        assert SH.param_spec("params/blocks/3/norm1/scale", (2560,),
                             mesh=m, fsdp=False) == ("model",)
        assert SH.param_spec("opt/slots/blocks/attn/wq/vr", (36, 2560),
                             mesh=m, fsdp=False) == (None, "model")
        assert SH.param_spec("params/final_norm/scale", (2560,), mesh=m,
                             fsdp=False) == ("model",)
        assert SH.param_spec("params/embed/table", (151936, 2560), mesh=m,
                             fsdp=True) == ("model", None)


def test_launch_modules_import_neither_jax_nor_reference():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    launch = [f"repro_torch.launch.{n}" for n in (
        "mesh", "sharding", "dispatch_cost", "roofline", "dryrun",
        "hillclimb", "train", "serve")]
    assert set(launch) <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {launch!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
