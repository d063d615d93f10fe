"""Port kernels (plain path on the CPU) against the reference package.

The port's ``senseamp_resolve`` / ``senseamp_resolve_trials`` are held
against ``repro.kernels.ops`` (the Pallas kernel in interpret mode) and
``repro.kernels.ref`` on the same numpy-made inputs, exactly; the gather
entry point the simulator calls is held against the slab front end.  The
CUDA kernel itself runs only on the card (``cuda`` marker); the JAX
reference comes from a fixture, so that test also collects where JAX is
not installed.
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import senseamp as S

RNG = np.random.default_rng(0)
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def J():
    """The reference: jax.numpy and ``repro.kernels.ops`` / ``.ref``."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref)


def _both(J, *arrays):
    return ([J.jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_senseamp_matches_ref_and_sim_semantics(J):
    w = 2500
    com = RNG.random((4, w), dtype=np.float32)
    rfc = RNG.random((4, w), dtype=np.float32)
    st_ = RNG.normal(0, .02, w).astype(np.float32)
    nz = RNG.normal(0, 1, w).astype(np.float32)
    un = RNG.random((2, w), dtype=np.float32)
    j, t = _both(J, com, rfc, st_, nz, un)
    kw = dict(u_com=.1, u_ref=.1, shift=.02, pf=.05, trial_sigma=.012)
    got = ops.senseamp_resolve(*t, **kw).numpy()
    pallas = np.asarray(J.ops.senseamp_resolve(*j, **kw))
    want = np.asarray(J.ref.senseamp_resolve(
        (j[0] - 0.5).sum(0) * .1, (j[1] - 0.5).sum(0) * .1, j[2], j[3],
        j[4], shift=.02, pf=.05, trial_sigma=.012))
    assert got.dtype == np.uint8 and got.shape == (w,)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("static_plane", [False, True])
def test_senseamp_resolve_trials_matches_ref(J, static_plane):
    """Trial axis folded into lanes == the reference, with a (W,) static
    row or a per-trial (T, W) static plane (the fused-bank layout)."""
    t, n, w = 5, 3, 700
    com = RNG.random((t, n, w), dtype=np.float32)
    rfc = RNG.random((t, n + 1, w), dtype=np.float32)
    st_ = RNG.normal(0, .02, (t, w) if static_plane else w) \
        .astype(np.float32)
    nz = RNG.normal(0, 1, (t, w)).astype(np.float32)
    un = RNG.random((2, t, w), dtype=np.float32)
    j, tt = _both(J, com, rfc, st_, nz, un)
    kw = dict(u_com=.09, u_ref=.11, shift=.015, pf=.03, trial_sigma=.01)
    got = ops.senseamp_resolve_trials(*tt, **kw).numpy()
    assert got.shape == (t, w)
    assert np.array_equal(got, np.asarray(J.ops.senseamp_resolve_trials(
        *j, **kw)))
    assert np.array_equal(got, np.asarray(J.ref.senseamp_resolve_trials(
        *j, **kw)))
    # the port's own oracle keeps the reference's formula
    assert np.array_equal(got, ref.senseamp_resolve_trials(*tt, **kw)
                          .numpy())


def test_senseamp_degenerate_floor(J):
    """pf=1 -> pure coin flip from uniforms."""
    w = 1024
    z = torch.zeros((1, w))
    un = RNG.random((2, w), dtype=np.float32)
    got = ops.senseamp_resolve(z, z, torch.zeros(w), torch.zeros(w),
                               torch.from_numpy(un), u_com=.1, u_ref=.1,
                               shift=0., pf=1.0, trial_sigma=0.)
    jnp = J.jnp
    want = J.ops.senseamp_resolve(jnp.zeros((1, w)), jnp.zeros((1, w)),
                                  jnp.zeros(w), jnp.zeros(w),
                                  jnp.asarray(un), u_com=.1, u_ref=.1,
                                  shift=0., pf=1.0, trial_sigma=0.)
    assert np.array_equal(got.numpy(), un[1] < 0.5)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_gather_reads_slots_like_the_slab():
    """Slot indices + column offset into a (T, slots, row_bits) buffer give
    the slab front end's answer on the gathered slab."""
    t, slots, rb, w = 4, 9, 96, 48
    com = torch.from_numpy(RNG.random((t, slots, rb), dtype=np.float32))
    rfc = torch.from_numpy(RNG.random((t, slots, rb), dtype=np.float32))
    rows_c, rows_r = [7, 2, 5], [0, 8]
    nz = torch.from_numpy(RNG.normal(0, 1, (t, w)).astype(np.float32))
    un = torch.from_numpy(RNG.random((2, t, w), dtype=np.float32))
    st_ = torch.from_numpy(RNG.normal(0, .02, w).astype(np.float32))
    kw = dict(u_com=.09, u_ref=.11, pf=.2)
    got = ops.senseamp_gather(com, rows_c, w, rfc, rows_r, 0, width=w,
                              static=st_, normals=nz, sigma=.01, u0=un[0],
                              u1=un[1], thr=.015, **kw)
    want = ops.senseamp_resolve_trials(
        com[:, rows_c, w:2 * w], rfc[:, rows_r, :w], st_, nz, un,
        shift=.015, trial_sigma=.01, **kw)
    assert np.array_equal(got.numpy(), want.numpy())


def test_gather_single_uniform_floor():
    """Batched floor: one uniform decides flip (u < pf) and coin
    (u < pf/2), the simulator's encoding."""
    t, w = 3, 64
    z = torch.full((t, 2, w), 0.5)
    u = torch.from_numpy(RNG.random((t, w), dtype=np.float32))
    got = ops.senseamp_gather(z, [0, 1], 0, z, [0], 0, width=w, u_com=.1,
                              u_ref=.1, normals=torch.zeros(t, w), u0=u,
                              pf=.5, thr=1.0)
    want = torch.where(u < .5, u < .25, torch.zeros_like(u, dtype=bool))
    assert np.array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bad", ["rows", "cols", "static", "coin"])
def test_gather_rejects_bad_arguments(bad):
    cells = torch.zeros((2, 4, 32))
    kw = dict(width=16, u_com=.1, u_ref=.1)
    args = [cells, [0, 1], 16, cells, [2], 0]
    if bad == "rows":
        args[1] = [0, 4]
    elif bad == "cols":
        args[2] = 20
    elif bad == "static":
        kw["static"] = torch.zeros(15)
    else:
        kw["u1"] = torch.zeros((2, 16))
    with pytest.raises((ValueError, IndexError)):
        ops.senseamp_gather(*args, **kw)


@pytest.mark.parametrize("seed,w", [(0, 32), (1, 100), (2, 400), (3, 1)])
def test_pack_unpack_roundtrip(J, seed, w):
    rng = np.random.default_rng(seed)
    w32 = ((w + 31) // 32) * 32
    bits = rng.integers(0, 2, (3, w32), dtype=np.uint8)
    words = ref.pack_bits(torch.from_numpy(bits))
    assert words.dtype == torch.int32
    want = np.asarray(J.ref.pack_bits(J.jnp.asarray(bits)))
    assert np.array_equal(words.numpy().view(np.uint32), want)
    assert np.array_equal(ref.unpack_bits(words).numpy(), bits)
    assert np.array_equal(
        ref.unpack_bits(words).numpy(),
        np.asarray(J.ref.unpack_bits(J.jnp.asarray(want))))


@pytest.mark.parametrize("name", ["device", "analog", "decoder"])
def test_host_modules_are_copies(name):
    """The port keeps its own copies of the reference's host modules."""
    port = (SRC / "repro_torch" / "core" / f"{name}.py").read_text()
    assert port == (SRC / "repro" / "core" / f"{name}.py").read_text()


@pytest.mark.cuda
def test_senseamp_kernel_matches_plain_on_card():
    """The Hopper kernel == its plain twin, bit for bit, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    t, slots, rb, w = 37, 20, 2048, 1024
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for cells in (torch.randint(0, 3, (2, t, slots, rb), generator=g,
                                device=dev).float() * 0.5,
                  torch.rand((2, t, slots, rb), generator=g, device=dev)):
        com, rfc = cells[0].contiguous(), cells[1].contiguous()
        nz = torch.randn((t, w), generator=g, device=dev)
        un = torch.rand((2, t, w), generator=g, device=dev)
        st_ = 0.02 * torch.randn((w,), generator=g, device=dev)
        for u1 in (None, un[1]):
            args = (com, [3, 17, 0, 9], w, rfc, [5, 6], 0)
            kw = dict(width=w, u_com=.1, u_ref=.125, static=st_, normals=nz,
                      sigma=.01, u0=un[0], u1=u1, pf=.05, thr=.01)
            before = S.launches
            got = S.senseamp_gather_cuda(*args, **kw)
            assert S.launches == before + 1
            want = S.senseamp_gather_plain(*args, **kw)
            assert torch.equal(got, want)
