"""Device meshes of the port (``repro.launch.mesh``) on torch's
``DeviceMesh``.

Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2, data=16,
model=16) = 512; the ``pod`` axis is a pure data-parallel axis whose
gradient reduction crosses the inter-pod link (where int8-EF gradient
compression applies, ``repro_torch.train.compress``).

A mesh spans the ranks of the initialised default process group: one
process per device (``torchrun``), or a *fake* group of N ranks in one
process for the dry-run and the tests (:func:`fake_group`).  The fake
group is torch's ``FakeProcessGroup`` from
``torch.testing._internal.distributed.fake_pg``, a private torch module
(present in the CPU and the CUDA builds this port runs on): every
collective returns at once with its result's shape and writes nothing, so
a step on DTensors traces the sharded program as rank 0 of N without N
devices.

Functions, not module constants: importing this module opens no group.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``"pod"`` in
    front, over the initialised group (256 / 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(*, model: int | None = None,
                   device: str = "cuda") -> DeviceMesh:
    """``(world / model, model)`` ``("data", "model")`` over every rank of
    the initialised group (tests, the launcher)."""
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str = "cuda") -> DeviceMesh:
    """A mesh of any shape over the initialised group (a logical remap of
    the same ranks: ``hillclimb``'s ``remesh``)."""
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))


def dp_axes(mesh) -> tuple[str, ...]:
    """The pure data-parallel axes of a mesh (everything but ``model``)."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of ``world_size`` ranks in this process
    (this process is rank 0), destroyed on exit.  Raises if a group is
    already initialised."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
