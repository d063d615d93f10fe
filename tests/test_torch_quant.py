"""Port binary-dot-product kernels and binarized linears (CPU) against the
reference package.

``popcount_gemm`` (and, xnor, ragged M / N / KB) and ``maj3`` equal the
reference's Pallas kernels (interpret mode on the CPU) and its oracles
exactly; ``popcount_gemm_bits`` keeps the xnor pad correction;
``binary_matmul`` matches ``repro.models.quant`` within 1e-6 relative (the
two frameworks reduce the per-row mean |x| in different orders, so the
scales may differ in the last float32 bit), and the STE gradients match
``jax.grad`` within 1e-5 relative (float32 products summed in different
orders).  Inputs are made with numpy and handed to both packages; packed
words cross over as int32 views of the reference's uint32 words.  Tests
marked ``cuda`` hold each kernel to its plain twin on the card; the
reference (which needs jax) comes in through a fixture, so they collect
where jax is not installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.kernels import bitwise as BW
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import popcount_gemm as PG
from repro_torch.kernels import ref as tref
from repro_torch.models import quant as TQ

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module")
def J():
    """The reference: jax, jax.numpy, ``repro.kernels.ops`` / ``.ref`` and
    ``repro.models.quant``."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as rkops
    from repro.kernels import ref as rref
    from repro.models import quant as RQ
    return SimpleNamespace(jax=jax, jnp=jnp, ops=rkops, ref=rref, quant=RQ)


def _words(*shape) -> np.ndarray:
    return RNG.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


# ---------------------------------------------------------------------------
# Kernels' plain twins vs the Pallas kernels (interpret) and the oracles
# ---------------------------------------------------------------------------
def test_popcount32_counts_every_bit():
    x = np.concatenate([_words(4000), np.asarray(
        [0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1, 0x55555555, 0xAAAAAAAA],
        dtype=np.uint32)])
    want = np.asarray([bin(int(v)).count("1") for v in x])
    assert np.array_equal(tref.popcount32(_t(x)).numpy(), want)


@pytest.mark.parametrize("kind", ["and", "xnor"])
@pytest.mark.parametrize("m,n,kb", [(8, 8, 2), (100, 70, 40), (128, 128, 64),
                                    (130, 50, 65)])
def test_popcount_gemm_matches_pallas(kind, m, n, kb, J):
    x, w = _words(m, kb), _words(n, kb)
    got = tkops.popcount_gemm(_t(x), _t(w), kind=kind)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    pallas = J.ops.popcount_gemm(J.jnp.asarray(x), J.jnp.asarray(w), kind=kind)
    oracle = J.ref.popcount_gemm(J.jnp.asarray(x), J.jnp.asarray(w), kind=kind)
    assert np.array_equal(got.numpy(), np.asarray(pallas))
    assert np.array_equal(got.numpy(), np.asarray(oracle))


def test_popcount_gemm_chunks_over_m(monkeypatch):
    """The plain twin's M chunking (a chunk of 3 rows here) changes
    nothing."""
    x, w = _words(10, 5), _words(7, 5)
    whole = tkops.popcount_gemm(_t(x), _t(w), kind="xnor")
    monkeypatch.setattr(tref, "GEMM_CHUNK_BYTES", 16 * 7 * 5 * 3)
    assert torch.equal(tkops.popcount_gemm(_t(x), _t(w), kind="xnor"),
                       whole)


def test_popcount_gemm_xnor_is_pm1_matmul():
    m, n, k = 16, 12, 96
    xb = RNG.integers(0, 2, (m, k), dtype=np.uint8)
    wb = RNG.integers(0, 2, (n, k), dtype=np.uint8)
    got = tkops.popcount_gemm(tkops.pack_bits(torch.from_numpy(xb)),
                              tkops.pack_bits(torch.from_numpy(wb)),
                              kind="xnor")
    pm1 = lambda b: 2 * b.astype(np.int64) - 1
    assert np.array_equal(got.numpy(), pm1(xb) @ pm1(wb).T)


#: the card kernel's output tile and the K words a row of one pipeline stage
#: (csrc/popcount_gemm.cu: BM, BN, KW)
TILE_M, TILE_N, STAGE_WORDS = 64, 128, 16


def _b1_model(x: torch.Tensor, w: torch.Tensor, kind: str,
              pad: int = 0) -> torch.Tensor:
    """The card kernel's algorithm in plain PyTorch: the words padded with
    ``pad`` to whole 64 x 128 tiles and 512-bit K stages, AND counts over
    the padded words (the tensor cores' only count), then for xnor
    ``32·KB − 2·popc(x ^ w)`` with ``popc(x ^ w) = (pc(x) − a) + (pc(w) −
    a)`` from the row popcounts of the operands as given."""
    (m, kb), n = x.shape, w.shape[0]
    up = lambda v, t: max(1, -(-v // t)) * t               # noqa: E731
    xp = torch.full((up(m, TILE_M), up(kb, STAGE_WORDS)), pad,
                    dtype=torch.int32)
    wp = torch.full((up(n, TILE_N), up(kb, STAGE_WORDS)), pad,
                    dtype=torch.int32)
    xp[:m, :kb], wp[:n, :kb] = x, w
    a = tref.popcount_gemm(xp, wp, "and")[:m, :n]
    if kind == "and":
        return a
    d = ((tref.popcount32(x).sum(1)[:, None] - a)
         + (tref.popcount32(w).sum(1)[None, :] - a))
    return (32 * kb - d) - d


@pytest.mark.parametrize("kind", ["and", "xnor"])
@pytest.mark.parametrize("m,n,kb", [(1, 1, 1), (8, 8, 2), (130, 50, 65),
                                    (129, 193, 5), (77, 3, 7),
                                    (200, 300, 17)])
def test_popcount_gemm_b1_model_matches_pallas(kind, m, n, kb, J):
    """The card kernel's algorithm where it can run -- AND counts over
    zero-padded tiles, xnor from them and the row popcounts -- equals the
    Pallas kernel (interpret), with no correction for the padding.  Padding
    with ones instead would add 32 per padded word to every AND count."""
    x, w = _words(m, kb), _words(n, kb)
    got = _b1_model(_t(x), _t(w), kind)
    pallas = J.ops.popcount_gemm(J.jnp.asarray(x), J.jnp.asarray(w), kind=kind)
    assert np.array_equal(got.numpy(), np.asarray(pallas))
    if kind == "and":
        padded = -(-kb // STAGE_WORDS) * STAGE_WORDS - kb
        assert torch.equal(_b1_model(_t(x), _t(w), kind, pad=-1) - got,
                           torch.full_like(got, 32 * padded))


@pytest.mark.parametrize("r,c", [(8, 512), (16, 1024), (13, 700), (1, 3)])
def test_maj3_matches_pallas(r, c, J):
    a, b, cc = _words(r, c), _words(r, c), _words(r, c)
    got = tkops.maj3(_t(a), _t(b), _t(cc))
    pallas = J.ops.maj3(J.jnp.asarray(a), J.jnp.asarray(b), J.jnp.asarray(cc))
    oracle = J.ref.maj3(J.jnp.asarray(a), J.jnp.asarray(b), J.jnp.asarray(cc))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(pallas))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(oracle))


@pytest.mark.parametrize("kind", ["and", "xnor"])
@pytest.mark.parametrize("k", [10, 32, 70])
def test_popcount_gemm_bits_matches_reference(kind, k, J):
    x = RNG.integers(0, 2, (3, k), dtype=np.uint8)
    w = RNG.integers(0, 2, (4, k), dtype=np.uint8)
    got = tkops.popcount_gemm_bits(x, w, kind=kind, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(
        J.ops.popcount_gemm_bits(x, w, kind=kind)))
    if kind == "xnor":     # the pad correction: a true {-1,+1} dot
        pm = np.where(x[:, None, :] == w[None, :, :], 1, -1).sum(-1)
    else:
        pm = x.astype(np.int64) @ w.T
    assert np.array_equal(got.numpy(), pm)


def test_popcount_gemm_bits_runs_where_its_tensors_are():
    """A tensor argument sets the device; anything else goes to the card,
    which raises here instead of running on the CPU."""
    x = RNG.integers(0, 2, (3, 40), dtype=np.uint8)
    w = RNG.integers(0, 2, (4, 40), dtype=np.uint8)
    got = tkops.popcount_gemm_bits(torch.from_numpy(x), w)
    assert got.device.type == "cpu"
    assert np.array_equal(got.numpy(), x.astype(np.int64) @ w.T)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkops.popcount_gemm_bits(x, w)


@pytest.mark.parametrize("bad", ["dtype", "rank", "k", "kind", "maj3"])
def test_kernel_entry_points_reject_bad_input(bad):
    x = _t(_words(4, 3))
    calls = {
        "dtype": lambda: tkops.popcount_gemm(x.long(), x),
        "rank": lambda: tkops.popcount_gemm(x[0], x),
        "k": lambda: tkops.popcount_gemm(x, x[:, :2]),
        "kind": lambda: tkops.popcount_gemm(x, x, kind="or"),
        "maj3": lambda: tkops.maj3(x, x, x[:2]),
    }
    with pytest.raises(ValueError):
        calls[bad]()


# ---------------------------------------------------------------------------
# Binary linears vs repro.models.quant
# ---------------------------------------------------------------------------
def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("k", [64, 70])
def test_binary_matmul_matches_reference(k, J):
    x = RNG.normal(0, 1, (6, k)).astype(np.float32)
    w = RNG.normal(0, 1, (5, k)).astype(np.float32)
    xq, sx = TQ.binarize_pack(torch.from_numpy(x))
    rxq, rsx = J.quant.binarize_pack(J.jnp.asarray(x))
    assert np.array_equal(xq.numpy().view(np.uint32), np.asarray(rxq))
    assert _rel(sx.numpy(), np.asarray(rsx)) <= 1e-6
    got = TQ.binary_matmul(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(J.quant.binary_matmul(J.jnp.asarray(x),
                                            J.jnp.asarray(w)))
    assert _rel(got.numpy(), want) <= 1e-6
    # the integer dots are exact: divide the scales back out
    dots = got.numpy() / sx.numpy() / TQ.binarize_pack(
        torch.from_numpy(w))[1].numpy().T
    pm1 = lambda a: np.where(a >= 0, 1, -1)
    assert np.allclose(dots, pm1(x) @ pm1(w).T, rtol=1e-5)


def test_ste_gradients_match_jax(J):
    x = RNG.normal(0, 0.5, (4, 70)).astype(np.float32)
    p = {"w": (RNG.normal(0, 1, (8, 70)) / np.sqrt(70)).astype(np.float32)}

    def loss(p, x):
        return J.jnp.sum(J.quant.apply_binary_linear(p, x) ** 2)

    gw, gx = J.jax.grad(loss, argnums=(0, 1))(
        {"w": J.jnp.asarray(p["w"])}, J.jnp.asarray(x))
    layer = convert.binary_linear_from_numpy(p, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    (layer(xt) ** 2).sum().backward()
    assert _rel(layer.weight.grad.numpy(), np.asarray(gw["w"])) <= 1e-5
    assert _rel(xt.grad.numpy(), np.asarray(gx)) <= 1e-5
    assert float(layer.weight.grad.abs().max()) > 0


def test_binary_linear_trains():
    """The tiny STE regression of the reference's tests learns on the
    port too (60 SGD steps halve the loss)."""
    w_true = np.sign(RNG.normal(0, 1, (1, 32))).astype(np.float32)
    x = torch.from_numpy(RNG.normal(0, 1, (256, 32)).astype(np.float32))
    y = x @ torch.from_numpy(w_true).T
    p = {"w": (RNG.normal(0, 1, (1, 32)) / np.sqrt(32)).astype(np.float32)}
    layer = convert.binary_linear_from_numpy(p, device="cpu")
    opt = torch.optim.SGD(layer.parameters(), lr=0.05)

    def loss():
        return ((layer(x) - y) ** 2).mean()

    l0 = float(loss().detach())
    for _ in range(60):
        opt.zero_grad()
        loss().backward()
        opt.step()
    assert float(loss().detach()) < 0.5 * l0


def test_binary_linear_module_and_dtype_round_trip(J):
    g = torch.Generator().manual_seed(3)
    layer = TQ.BinaryLinear(40, 6, generator=g, device="cpu")
    x = torch.randn((2, 3, 40), generator=g)
    y = layer(x)
    assert y.shape == (2, 3, 6) and y.dtype == torch.float32
    assert torch.equal(y, TQ.apply_binary_linear({"w": layer.weight}, x))
    yb = layer(x.to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16 and yb.shape == (2, 3, 6)
    want = J.quant.apply_binary_linear(
        {"w": J.jnp.asarray(layer.weight.detach().numpy())},
        J.jnp.asarray(x.numpy()))
    assert _rel(y.detach().numpy(), np.asarray(want)) <= 1e-6
    p = TQ.init_binary_linear(40, 6, generator=g, device="cpu")
    assert p["w"].shape == (6, 40) and p["w"].dtype == torch.float32


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
def test_popcount_gemm_kernel_matches_plain_on_card(card):
    """Tile edges (64 x 128 tiles, 16-word K stages) crossed in M, N and
    KB, M and N below one tile, KB not a multiple of 4 and an operand 4
    bytes off alignment (the word copies), odd N (the scalar stores), both
    serve shapes; then the ±32·KB extremes."""
    for m, n, kb in ((8, 8, 2), (130, 50, 65), (64, 64, 32), (1, 1, 1),
                     (300, 257, 80), (77, 3, 304), (127, 255, 3),
                     (128, 256, 4), (129, 257, 5), (255, 191, 8),
                     (256, 193, 9), (257, 129, 33), (5, 100, 7),
                     (100, 5, 6), (130, 140, 16), (131, 129, 20),
                     (63, 129, 16), (65, 127, 17),
                     (2048, 9728, 80), (2048, 2560, 304)):
        x = _card_words(card, m, kb)
        w = _card_words(card, n, kb, seed=1)
        for kind in PG.KINDS:
            before = PG.launches["popcount_gemm"]
            got = PG.popcount_gemm_cuda(x, w, kind)
            assert PG.launches["popcount_gemm"] == before + 1
            assert torch.equal(got, PG.popcount_gemm_plain(x, w, kind)), \
                (m, n, kb, kind)
    x = _card_words(card, 70 * 8 + 1)[1:].view(70, 8)   # 4 bytes off
    w = _card_words(card, 90, 8, seed=1)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    for kind in PG.KINDS:
        assert torch.equal(PG.popcount_gemm_cuda(x, w, kind),
                           PG.popcount_gemm_plain(x, w, kind)), kind
    m, n, kb = 130, 70, 9
    ones = torch.full((m, kb), -1, dtype=torch.int32, device=card)
    zeros = torch.zeros((n, kb), dtype=torch.int32, device=card)
    for x, w, want_and, want_xnor in (
            (ones, ones[:n], 32 * kb, 32 * kb),
            (ones, zeros, 0, -32 * kb),
            (zeros[:1].expand(m, kb).contiguous(), zeros, 0, 32 * kb)):
        for kind, want in (("and", want_and), ("xnor", want_xnor)):
            got = PG.popcount_gemm_cuda(x, w, kind)
            assert torch.equal(got, PG.popcount_gemm_plain(x, w, kind))
            assert bool((got == want).all()), (kind, want)
    for m, n in ((0, 5), (5, 0)):       # nothing to launch, nothing counted
        before = PG.launches["popcount_gemm"]
        got = PG.popcount_gemm_cuda(_card_words(card, m, 3),
                                    _card_words(card, n, 3), "xnor")
        assert got.shape == (m, n)
        assert PG.launches["popcount_gemm"] == before


@pytest.mark.cuda
def test_maj3_kernel_matches_plain_on_card(card):
    for shape in ((256, 512), (7, 1001), (1, 3)):
        a, b, c = (_card_words(card, *shape, seed=s) for s in range(3))
        before = BW.launches["maj3"]
        got = BW.maj3_cuda(a, b, c)
        assert BW.launches["maj3"] == before + 1
        assert torch.equal(got, BW.maj3_plain(a, b, c)), shape


@pytest.mark.cuda
def test_binary_matmul_on_card_matches_cpu(card):
    g = torch.Generator().manual_seed(5)
    x, w = torch.randn((33, 70), generator=g), torch.randn((9, 70),
                                                           generator=g)
    got = TQ.binary_matmul(x.to(card), w.to(card)).cpu()
    assert _rel(got.numpy(), TQ.binary_matmul(x, w).numpy()) <= 1e-6
