"""Count the host's reads of device data, op by op.

:class:`HostReads` is a ``TorchDispatchMode``: every aten operation of the
calls made under it passes through :meth:`__torch_dispatch__`, which counts
``aten._local_scalar_dense`` (``.item()``, ``int()``, ``float()``,
``bool()`` of a tensor), ``aten.nonzero`` and the copies of a device
tensor to the host.  Each of them makes the host wait for the device.  The
count is exact: it does not depend on timing.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
_SCALAR = {_aten._local_scalar_dense.default}
_NONZERO = {_aten.nonzero.default}
_COPIES = {_aten._to_copy.default, _aten.copy_.default}


def _device(x) -> str | None:
    return x.device.type if isinstance(x, torch.Tensor) else None


class HostReads(TorchDispatchMode):
    """Counts host reads of device data while active (``reads``)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _SCALAR:
            self.reads += 1
        elif func in _NONZERO and _device(args[0]) != "cpu":
            self.reads += 1
        elif func in _COPIES and self._to_host(func, args, kwargs, out):
            self.reads += 1
        return out

    @staticmethod
    def _to_host(func, args, kwargs, out) -> bool:
        if func is _aten.copy_.default:         # copy_(dst, src)
            return _device(args[0]) == "cpu" and _device(args[1]) not in (
                None, "cpu")
        return _device(args[0]) not in (None, "cpu") and _device(out) == "cpu"
