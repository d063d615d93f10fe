"""The grouped expert product of a dropless MoE: the Hopper kernels (CUDA
C++, ``csrc/moe_grouped.cu``) and their plain twins, for relu² experts
(Nemotron-H) and SwiGLU experts (Granite 4.0-H).

Replaces no TPU kernel: the reference's MoE runs its experts as one batched
product over fixed-capacity ``(E, C, D)`` buffers, which drops tokens past
the capacity and multiplies every expert, rows or none.  A served model may
drop nothing, and a decode step at 16 slots gives rows to about half of 128
experts, so this product runs each expert on exactly its rows and never
reads the weights of an expert that has none.

The rows come sorted by expert (``xs`` (R, D), expert ``e`` owning rows
``offsets[e] : offsets[e + 1]``), with the ``(E + 1,)`` int32 ``offsets``
on the device: no size is read on the host, so the product is captured in
the decode step's CUDA graph.  Each expert computes ``down(relu(up(h))²)``
(Nemotron-H's relu² experts) with the published layout, K-major: ``w_up``
(E, F, D), ``w_down`` (E, D, F); the products accumulated in float32,
``relu(·)²`` rounded once to the compute type, the output rounded once
(bf16; float32 rows take full float32 products, without TF32).

:func:`grouped_experts_cuda` makes two launches of one kernel, ``up`` (with
the activation) then ``down``.  A block takes one tile of ``BM`` rows of
one expert and ``BN`` output columns: it loads the ``E + 1`` offsets,
scans each expert's tile count across its threads and finds its own, so
the grid is a fixed bound (``ceil(R / BM) + min(E, R)`` tiles) and blocks
past the last tile return at once.  bf16 rows run on ``wgmma``, in tiles
of 128 rows and 256 columns, from a 4-deep ``cp.async`` ring of
128B-swizzled tiles; float32 rows on the CUDA cores.  What bounds it: at
decode, the bytes of the weights of each expert with rows (about 20 MB an
expert at Nemotron 3 Nano's widths, rows a handful); at a long prefill the
same bytes and the products (``4 · R · D · F`` operations at the card's
bf16 rate).  Block ``(0, 0)`` of ``up`` also writes
one record of the launch — the experts that received rows and the rows —
into a small device ring (:func:`take_records`), which a graph replay
writes too; a CPU call appends the same record.

:func:`grouped_experts_plain` is the same function as a loop over the
experts that have rows, in float32 products: what a CPU tensor gets and
what the kernel is held against on the card.

SwiGLU experts (:func:`grouped_experts_swiglu`) compute ``down(silu(g) ·
u)`` with ``[g, u]`` the rows' product with ``w_gate_up`` (E, 2F, D),
Granite's ``input_linear`` (the gate rows first), and ``w_down`` (E, D, F).
:func:`grouped_experts_swiglu_cuda` makes two launches of the kernel
``moe_grouped_swiglu_*``: ``up``, whose blocks each take 128 output
columns and load the gate's and the up's rows for them into one 256-row
operand tile, so that one ``wgmma`` sum holds both and the epilogue
writes ``silu(g) · u`` rounded once; then ``down``, the plain product, under
the same kernel's name.  The tile scheduler, the ring of tiles and the
launch record are the relu² kernel's.  What bounds it: at decode the
bytes of each expert with rows (``3 · D · F`` values, about 18.9 MB at
Granite's widths); at a long prefill the ``6 · R · D · F`` operations.
:func:`grouped_experts_swiglu_plain` is its twin, as for relu².
"""
from __future__ import annotations

import ctypes

import torch

from .flash_attention import _stream

#: grouped products since the counts were last reset (plain calls not
#: counted), relu² and SwiGLU; each is two kernel launches, ``up`` then
#: ``down``
launches = {"moe_grouped": 0, "moe_grouped_swiglu": 0}
#: records kept at most in a device's ring (a serving call makes a few
#: thousand)
RING = 1 << 15

_RINGS: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
_LIB = None


def _ring(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's ring of launch records ``(RING, 2)`` int64 and its
    write counter ``(1,)`` int64, made on first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _RINGS:
        _RINGS[device] = (torch.zeros((RING, 2), dtype=torch.int64,
                                      device=device),
                          torch.zeros((1,), dtype=torch.int64, device=device))
    return _RINGS[device]


def reset_records(device) -> None:
    """Forget the device's launch records (a device write, no host read)."""
    _ring(device)[1].zero_()


def take_records(device) -> list[tuple[int, int]]:
    """The launch records since the last reset, oldest first, as ``(experts
    with rows, rows)``; reads the ring on the host and resets it.  Past
    :data:`RING` launches the oldest are lost."""
    ring, idx = _ring(device)
    n = int(idx.item())
    rows = ring.tolist()
    idx.zero_()
    if n <= RING:
        return [tuple(r) for r in rows[:n]]
    cut = n % RING
    return [tuple(r) for r in rows[cut:] + rows[:cut]]


def _check(xs, offsets, w_up, w_down, gates: int = 1) -> None:
    """``gates`` 2: ``w_up`` is SwiGLU's (E, 2F, D)."""
    if xs.dim() != 2 or w_up.dim() != 3 or w_down.dim() != 3:
        raise ValueError(f"want xs (R, D), w_up (E, {gates}F, D), w_down "
                         f"(E, D, F); got {tuple(xs.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)}")
    e, f, d = w_up.shape
    if f % gates:
        raise ValueError(f"w_gate_up {tuple(w_up.shape)}: want (E, 2F, D)")
    f //= gates
    if xs.shape[1] != d or tuple(w_down.shape) != (e, d, f):
        raise ValueError(f"xs {tuple(xs.shape)}, w_up {tuple(w_up.shape)} "
                         f"and w_down {tuple(w_down.shape)} do not fit")
    if tuple(offsets.shape) != (e + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"want int32 offsets ({e + 1},); got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if not (xs.dtype == w_up.dtype == w_down.dtype):
        raise ValueError(f"xs and the weights differ in type: {xs.dtype}, "
                         f"{w_up.dtype}, {w_down.dtype}")


def grouped_experts(xs: torch.Tensor, offsets: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """-> (R, D) in xs's type: rows ``offsets[e]:offsets[e+1]`` through
    expert ``e``'s ``down(relu(up(·))²)``.  The kernel on a CUDA tensor,
    the plain twin on a CPU one."""
    _check(xs, offsets, w_up, w_down)
    if xs.is_cuda:
        return grouped_experts_cuda(xs, offsets, w_up, w_down)
    return grouped_experts_plain(xs, offsets, w_up, w_down)


def grouped_experts_swiglu(xs: torch.Tensor, offsets: torch.Tensor,
                           w_gate_up: torch.Tensor, w_down: torch.Tensor
                           ) -> torch.Tensor:
    """-> (R, D) in xs's type: rows ``offsets[e]:offsets[e+1]`` through
    expert ``e``'s ``down(silu(g) · u)``, ``[g, u]`` their product with
    ``w_gate_up[e]`` (2F, D), the gate rows first.  The kernel on a CUDA
    tensor, the plain twin on a CPU one."""
    _check(xs, offsets, w_gate_up, w_down, gates=2)
    if xs.is_cuda:
        return grouped_experts_swiglu_cuda(xs, offsets, w_gate_up, w_down)
    return grouped_experts_swiglu_plain(xs, offsets, w_gate_up, w_down)


def _plain(xs, offsets, w_down, act) -> torch.Tensor:
    """The twins' loop: each expert with rows (sizes read on the host)
    through ``act(rows, e)`` (float32) rounded once to xs's type, then
    ``w_down[e]`` in float32, rounded once; the launch record appended as
    the kernels write it."""
    off = offsets.tolist()
    cnt = [b - a for a, b in zip(off, off[1:])]
    ring, idx = _ring(xs.device)
    ring[int(idx) % RING] = torch.tensor(
        [sum(c > 0 for c in cnt), sum(cnt)], dtype=torch.int64)
    idx += 1
    out = torch.zeros_like(xs)
    for e, (a, b) in enumerate(zip(off, off[1:])):
        if b > a:
            h = act(xs[a:b].float(), e)
            out[a:b] = (h.to(xs.dtype).float() @ w_down[e].float().T).to(
                xs.dtype)
    return out


def grouped_experts_plain(xs, offsets, w_up, w_down) -> torch.Tensor:
    """The relu² twin: a loop over the experts with rows, float32
    products, the activation and the output each rounded once to xs's
    type."""
    return _plain(xs, offsets, w_down, lambda x, e: torch.relu(
        x @ w_up[e].float().T).square())


def grouped_experts_swiglu_plain(xs, offsets, w_gate_up, w_down
                                 ) -> torch.Tensor:
    """The SwiGLU twin: a loop over the experts with rows, float32
    products, ``silu(g) · u`` and the output each rounded once to xs's
    type."""
    def act(x, e):
        g, u = (x @ w_gate_up[e].float().T).chunk(2, -1)
        return torch.nn.functional.silu(g) * u

    return _plain(xs, offsets, w_down, act)


_VP, _INT = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    """``csrc/moe_grouped.cu``, built on first use."""
    global _LIB
    if _LIB is None:
        from . import build
        lib = build.load("moe_grouped")
        for fn in (lib.moe_grouped, lib.moe_grouped_swiglu):
            fn.argtypes = [_VP] * 8 + [_INT] * 6 + [_VP]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(name: str, xs, offsets, w_up, w_down, f: int) -> torch.Tensor:
    """The two launches of ``name`` (``moe_grouped`` or
    ``moe_grouped_swiglu``) on the current stream; raises on what the
    kernel does not take.  Allocates the (R, F) activation and the (R, D)
    output."""
    for arg, t in (("xs", xs), ("offsets", offsets), ("w_up", w_up),
                   ("w_down", w_down)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{arg} must be a contiguous CUDA tensor")
    if xs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bf16 or float32 rows, not "
                         f"{xs.dtype}")
    r, d = xs.shape
    e = w_up.shape[0]
    if d % 8 or f % 8:
        raise ValueError(f"the kernel takes widths that are multiples of 8, "
                         f"not D {d}, F {f}")
    out = torch.empty_like(xs)
    if r == 0:
        return out
    h = torch.empty((r, f), dtype=xs.dtype, device=xs.device)
    ring, idx = _ring(xs.device)
    dev = xs.device.index if xs.device.index is not None else \
        torch.cuda.current_device()
    err = getattr(_lib(), name)(
        xs.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
        out.data_ptr(), offsets.data_ptr(), ring.data_ptr(), idx.data_ptr(),
        RING, r, d, f, e, int(xs.dtype == torch.bfloat16), _stream(dev))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def grouped_experts_cuda(xs, offsets, w_up, w_down) -> torch.Tensor:
    """The relu² kernel's two launches (see :func:`_launch`)."""
    return _launch("moe_grouped", xs, offsets, w_up, w_down, w_up.shape[1])


def grouped_experts_swiglu_cuda(xs, offsets, w_gate_up, w_down
                                ) -> torch.Tensor:
    """The SwiGLU kernel's two launches (see :func:`_launch`)."""
    return _launch("moe_grouped_swiglu", xs, offsets, w_gate_up, w_down,
                   w_gate_up.shape[1] // 2)
