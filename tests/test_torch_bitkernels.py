"""Port plane kernels (plain path on the CPU) against the reference package.

``repro_torch.kernels.ops.nary_bitwise`` / ``bitwise_not`` / ``add_planes``
/ ``bitcount_planes`` on CPU tensors are held against ``repro.kernels.ref``
and the Pallas kernels in interpret mode (``repro.kernels.ops.*(...,
interpret=True)``) on the same numpy-made uint32 words, with tolerance 0:
these are integer functions.  The CUDA kernels run only on the card
(``cuda`` marker), held against their plain twins.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitserial as BS
from repro_torch.kernels import bitwise as BW
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(0)
OPS = ("and", "or", "nand", "nor", "xor")


@pytest.fixture(scope="module")
def J():
    """The reference: jax.numpy and ``repro.kernels.ops`` / ``.ref``."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref)


def _words(*shape) -> np.ndarray:
    return RNG.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 words as the port's int32 bit patterns (a view)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


#: N -> (R, C): aligned and ragged plane shapes
SHAPES = {1: (3, 70), 2: (8, 512), 5: (5, 130), 16: (4, 33)}


@pytest.mark.parametrize("n", sorted(SHAPES))
@pytest.mark.parametrize("op", OPS)
def test_nary_bitwise_matches_reference(J, op, n):
    p = _words(n, *SHAPES[n])
    got = _u32(ops.nary_bitwise(_t(p), op))
    jp = J.jnp.asarray(p)
    assert np.array_equal(got, np.asarray(J.ref.nary_bitwise(op, jp)))
    assert np.array_equal(got, np.asarray(
        J.ops.nary_bitwise(jp, op, interpret=True)))


@pytest.mark.parametrize("shape", [(8, 512), (3, 70)])
def test_bitwise_not_matches_reference(J, shape):
    p = _words(*shape)
    got = _u32(ops.bitwise_not(_t(p)))
    jp = J.jnp.asarray(p)
    assert np.array_equal(got, np.asarray(J.ref.not_(jp)))
    assert np.array_equal(got, np.asarray(
        J.ops.bitwise_not(jp, interpret=True)))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_add_planes_matches_reference(J, k):
    a, b = _words(k, 5, 130), _words(k, 5, 130)
    got = _u32(ops.add_planes(_t(a), _t(b)))
    assert got.shape == (k + 1, 5, 130)
    ja, jb = J.jnp.asarray(a), J.jnp.asarray(b)
    assert np.array_equal(got, np.asarray(J.ref.add_planes(ja, jb)))
    assert np.array_equal(got, np.asarray(
        J.ops.add_planes(ja, jb, interpret=True)))


@pytest.mark.parametrize("n", [1, 3, 8, 16])
def test_bitcount_planes_matches_reference(J, n):
    p = _words(n, 3, 70)
    got = _u32(ops.bitcount_planes(_t(p)))
    assert got.shape == (max(1, n.bit_length()), 3, 70)
    jp = J.jnp.asarray(p)
    assert np.array_equal(got, np.asarray(J.ref.bitcount_planes(jp)))
    assert np.array_equal(got, np.asarray(
        J.ops.bitcount_planes(jp, interpret=True)))


def test_add_and_count_are_integer_arithmetic():
    """The counter planes count set bits; the adder adds the bit-sliced
    integers (checked lane by lane on unpacked bits)."""
    k = 6
    a, b = _t(_words(k, 2, 8)), _t(_words(k, 2, 8))
    val = lambda planes: sum(ref.unpack_bits(planes[i]).long() << i
                             for i in range(planes.shape[0]))
    assert torch.equal(val(ops.add_planes(a, b)), val(a) + val(b))
    cnt = ops.bitcount_planes(a)
    assert torch.equal(val(cnt), sum(ref.unpack_bits(a[i]).long()
                                     for i in range(k)))


def test_nary_bitwise_bits_matches_reference(J):
    bv = RNG.integers(0, 2, (4, 77), dtype=np.uint8)
    got = ops.nary_bitwise_bits(torch.from_numpy(bv), "or")
    assert got.dtype == torch.uint8 and got.shape == (77,)
    assert np.array_equal(got.numpy(), np.asarray(
        J.ops.nary_bitwise_bits(J.jnp.asarray(bv), "or")))


@pytest.mark.parametrize("bad", ["op", "dtype", "rank", "empty", "shapes"])
def test_wrappers_reject_bad_arguments(bad):
    p = torch.zeros((2, 3, 4), dtype=torch.int32)
    calls = {
        "op": lambda: ops.nary_bitwise(p, "maj"),
        "dtype": lambda: ops.nary_bitwise(p.long(), "and"),
        "rank": lambda: ops.bitwise_not(p),
        "empty": lambda: ops.nary_bitwise(p[:0], "and"),
        "shapes": lambda: ops.add_planes(p, p[:, :2]),
    }
    with pytest.raises(ValueError):
        calls[bad]()


# ---------------------------------------------------------------------------
# On the card: each kernel == its plain twin, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_words(card, *shape, seed: int = 0) -> torch.Tensor:
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                         dtype=torch.int64, device=card).to(torch.int32)


@pytest.mark.cuda
def test_nary_bitwise_kernel_matches_plain_on_card(card):
    for shape in ((16, 64, 512), (1, 3, 70), (17, 7, 1000), (5, 1, 4097)):
        p = _card_words(card, *shape)
        for op in OPS:
            before = BW.launches["nary_bitwise"]
            got = BW.nary_bitwise_cuda(p, op)
            assert BW.launches["nary_bitwise"] == before + 1
            assert torch.equal(got, BW.nary_bitwise_plain(p, op)), (shape, op)


@pytest.mark.cuda
def test_bitwise_not_kernel_matches_plain_on_card(card):
    """Whole unrolled steps, remainders after them (vectors and a 1-3 word
    scalar tail), a tail alone, the main-path shape, and an unaligned view
    (the scalar kernel)."""
    for shape in ((256, 512), (7, 1001), (1, 4097), (3, 1365), (1, 3),
                  (1, 1), (1000, 1003), (16384, 512)):
        p = _card_words(card, *shape)
        before = BW.launches["bitwise_not"]
        got = BW.bitwise_not_cuda(p)
        assert BW.launches["bitwise_not"] == before + 1
        assert torch.equal(got, BW.bitwise_not_plain(p)), shape
    p = _card_words(card, 1, 4101)[:, 1:]        # 4 bytes past an alignment
    assert p.is_contiguous() and p.data_ptr() % 16 == 4
    assert torch.equal(BW.bitwise_not_cuda(p), BW.bitwise_not_plain(p))


@pytest.mark.cuda
def test_add_planes_kernel_matches_plain_on_card(card):
    for k, shape in ((1, (8, 512)), (16, (64, 1024)), (9, (3, 70))):
        a = _card_words(card, k, *shape)
        b = _card_words(card, k, *shape, seed=1)
        before = BS.launches["add_planes"]
        got = BS.add_planes_cuda(a, b)
        assert BS.launches["add_planes"] == before + 1
        assert torch.equal(got, BS.add_planes_plain(a, b)), (k, shape)


@pytest.mark.cuda
def test_bitcount_planes_kernel_matches_plain_on_card(card):
    for n, shape in ((1, (8, 512)), (16, (64, 1024)), (33, (3, 70)),
                     (255, (2, 36))):
        p = _card_words(card, n, *shape)
        before = BS.launches["bitcount_planes"]
        got = BS.bitcount_planes_cuda(p)
        assert BS.launches["bitcount_planes"] == before + 1
        assert torch.equal(got, BS.bitcount_planes_plain(p)), (n, shape)
