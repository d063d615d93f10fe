"""The port's flash-attention forward against the reference package.

``flash_attention_plain`` (what a CPU tensor gets through
``ops.flash_attention``) equals ``repro.models.layers.fused_flash_fwd`` —
the forward of the reference's ``fused_attention`` region — in ``out`` and
``lse`` within 1e-5 in float32 (the same products summed in another
order): causal, sliding window, softcap, GQA (the port's unrepeated K/V
against the reference's repeated), one query against a cache holding
``POS_SENTINEL`` slots, ragged Sq / Sk.  It also equals the Pallas kernel
``repro.kernels.flash_attention.flash_attention`` (interpret mode) and the
unfused ``_flash_attend`` path.  Inputs are made with numpy and handed to
both packages.  Tests marked ``cuda`` hold the kernel to the plain version
on the card; the reference (which needs jax) comes in through a fixture,
so they collect where jax is not installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

SENTINEL = (2 ** 31 - 1) // 2


@pytest.fixture(scope="module")
def J():
    """The reference: jax.numpy, ``repro.models.layers`` and the Pallas
    kernel module."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention as RFA
    from repro.models import layers as RL
    return SimpleNamespace(jnp=jnp, layers=RL, pallas=RFA)


def _case(seed, b, sq, sk, h, kv, hd, *, q0=0, tail=0, dtype=np.float32):
    """q (B, Sq, H, hd), k / v (B, Sk, KV, hd) normals; queries at
    positions q0 .. q0+Sq-1, keys at 0 .. Sk-1 with the last ``tail`` of
    the second batch row set to the sentinel."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, sq, h, hd)).astype(dtype)
    k = rng.normal(0, 1, (b, sk, kv, hd)).astype(dtype)
    v = rng.normal(0, 1, (b, sk, kv, hd)).astype(dtype)
    qp = np.tile(np.arange(q0, q0 + sq, dtype=np.int32), (b, 1))
    kp = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    if tail:
        kp[-1, sk - tail:] = SENTINEL
    return q, k, v, qp, kp


def _reference(J, q, k, v, qp, kp, **kw):
    rep = q.shape[2] // k.shape[2]
    out, lse = J.layers.fused_flash_fwd(
        J.jnp.asarray(q), J.jnp.repeat(J.jnp.asarray(k), rep, axis=2),
        J.jnp.repeat(J.jnp.asarray(v), rep, axis=2), J.jnp.asarray(qp),
        J.jnp.asarray(kp), **kw)
    return np.asarray(out), np.asarray(lse)


def _port(q, k, v, qp, kp, **kw):
    out, lse = ops.flash_attention(*(torch.from_numpy(x)
                                     for x in (q, k, v, qp, kp)), **kw)
    return out.numpy(), lse.numpy()


#: (B, Sq, Sk, H, KV, hd, q0, sentinel tail, window, softcap)
CASES = {
    "causal": (2, 64, 64, 4, 4, 16, 0, 0, 0, 0.0),
    "window": (1, 96, 96, 2, 2, 16, 0, 0, 17, 0.0),
    "softcap": (2, 48, 48, 4, 2, 16, 0, 0, 0, 5.0),
    "gqa": (2, 40, 40, 8, 2, 32, 0, 0, 0, 0.0),
    "decode_sentinel": (3, 1, 80, 4, 2, 16, 49, 30, 0, 0.0),
    "ragged": (2, 37, 1100, 6, 3, 24, 1063, 200, 0, 0.0),
    "ragged_window_softcap": (2, 29, 70, 4, 1, 8, 41, 9, 7, 2.5),
    "prefill_into_cache": (1, 33, 128, 4, 2, 16, 0, 0, 0, 0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_fused_flash_fwd(name, J):
    b, sq, sk, h, kv, hd, q0, tail, window, softcap = CASES[name]
    q, k, v, qp, kp = _case(1, b, sq, sk, h, kv, hd, q0=q0, tail=tail)
    if name == "prefill_into_cache":        # keys past the prompt: unwritten
        kp[:, sq:] = SENTINEL
    want = _reference(J, q, k, v, qp, kp, window=window, softcap=softcap)
    got = _port(q, k, v, qp, kp, window=window, softcap=softcap)
    assert got[0].shape == (b, sq, h, hd) and got[1].shape == (b, h, sq)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


def test_rows_that_see_nothing_give_zero(J):
    """Queries before every key (and a whole-sentinel cache row) give 0 and
    the reference's lse, m0 + log(1e-20)."""
    q, k, v, qp, kp = _case(2, 2, 3, 20, 2, 1, 16, q0=0)
    kp[:] += 5
    kp[1] = SENTINEL
    got = _port(q, k, v, qp, kp)
    want = _reference(J, q, k, v, qp, kp, window=0, softcap=0.0)
    assert not got[0].any()
    np.testing.assert_array_equal(got[1], want[1])


def test_plain_bf16_matches_reference_bf16(J):
    """bf16 operands: the same exact products, float32 softmax and P
    rounded to bf16 before P.V; the outputs differ by at most the last
    rounding of out to bf16 (2**-8 relative, |out| < 2)."""
    import ml_dtypes
    q, k, v, qp, kp = _case(3, 2, 50, 50, 4, 2, 16,
                            dtype=ml_dtypes.bfloat16)
    want = _reference(J, q, k, v, qp, kp, window=0, softcap=0.0)
    tq, tk, tv = (torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
                  for x in (q, k, v))
    out, lse = ops.flash_attention(tq, tk, tv, torch.from_numpy(qp),
                                   torch.from_numpy(kp))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               want[0].astype(np.float32), rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(lse.numpy(), want[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("window", [0, 300])
def test_plain_matches_pallas_kernel(window, J):
    """The Pallas kernel's own (BH, S, hd) layout is B = BH, H = KV = 1."""
    q, k, v, qp, kp = _case(4, 2, 1024, 1024, 1, 1, 16)
    want = J.pallas.flash_attention(
        J.jnp.asarray(q[:, :, 0]), J.jnp.asarray(k[:, :, 0]),
        J.jnp.asarray(v[:, :, 0]), J.jnp.asarray(qp), J.jnp.asarray(kp),
        window=window, interpret=True)
    got, _ = _port(q, k, v, qp, kp, window=window)
    np.testing.assert_allclose(got[:, :, 0], np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (11, 0.0), (0, 4.0)])
def test_plain_matches_unfused_path(window, softcap, J):
    q, k, v, qp, kp = _case(5, 2, 70, 70, 4, 2, 16)
    rep = q.shape[2] // k.shape[2]
    want = J.layers._flash_attend(
        J.jnp.asarray(q), J.jnp.repeat(J.jnp.asarray(k), rep, axis=2),
        J.jnp.repeat(J.jnp.asarray(v), rep, axis=2), J.jnp.asarray(qp),
        J.jnp.asarray(kp), sliding_window=window, softcap=softcap)
    got, _ = _port(q, k, v, qp, kp, window=window, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(6, 1, 5, 9, 2, 1,
                                                          16))
    before = FA.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, qp, kp)
    want = FA.flash_attention_plain(q, k, v, qp, kp)
    assert FA.launches["flash_attention"] == before
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("bad", ["kv_shape", "groups", "hd", "pos_dtype",
                                 "pos_shape", "types", "no_keys"])
def test_entry_point_rejects_bad_input(bad):
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(7, 1, 4, 6, 4, 2,
                                                          16))
    args = {
        "kv_shape": (q, k, v[:, :5], qp, kp),
        "groups": (q[:, :, :3], k, v, qp, kp),
        "hd": (q, k[..., :8], v[..., :8], qp, kp),
        "pos_dtype": (q, k, v, qp.long(), kp),
        "pos_shape": (q, k, v, qp, kp[:, :5]),
        "types": (q, k.double(), v.double(), qp, kp),
        "no_keys": (q, k[:, :0], v[:, :0], qp, kp[:, :0]),
    }[bad]
    with pytest.raises(ValueError):
        ops.flash_attention(*args)


def test_kernel_wrapper_wants_cuda_tensors():
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(8, 1, 4, 6, 2, 1,
                                                          16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.flash_attention_cuda(q, k, v, qp, kp)


# ---------------------------------------------------------------------------
# On the card: the kernel == its plain twin
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


#: (B, Sq, Sk, H, KV, hd, q0, sentinel tail, window, softcap)
CARD_CASES = (
    (1, 256, 512, 32, 8, 80, 0, 256, 0, 0.0),      # prefill into a cache
    (4, 1, 700, 32, 8, 80, 650, 50, 0, 0.0),       # decode
    (2, 77, 300, 6, 2, 64, 223, 40, 37, 30.0),     # ragged, window, softcap
    (2, 130, 130, 4, 4, 128, 0, 0, 0, 0.0),        # hd 128, no grouping
    (1, 9, 1000, 3, 1, 16, 991, 0, 0, 0.0),        # G = 3, hd 16
    (2, 20, 45, 4, 2, 8, 25, 10, 5, 0.0),          # hd 8 (padded to 16)
    (1, 3, 20, 2, 1, 16, -10, 0, 0, 0.0),          # rows before every key
)


def _card_inputs(card, case, qdt, kvdt, seed):
    b, sq, sk, h, kv, hd, q0, tail, _w, _c = case
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g, device=card).to(qdt)
    k = torch.randn((b, sk, kv, hd), generator=g, device=card).to(kvdt)
    v = torch.randn((b, sk, kv, hd), generator=g, device=card).to(kvdt)
    qp = (torch.arange(sq, dtype=torch.int32, device=card) + q0).repeat(b, 1)
    kp = torch.arange(sk, dtype=torch.int32, device=card).repeat(b, 1)
    if tail:
        kp[-1, sk - tail:] = SENTINEL
    return q, k, v, qp, kp


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", [
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_flash_attention_kernel_matches_plain_on_card(qdt, kvdt, card):
    """float32: 1e-5 on out and lse (only the summation order differs).
    bf16 q: out within 1e-2 (P and out rounded to bf16 at other tile
    boundaries), lse within 1e-4 (float32 sums of the same products)."""
    tol = (1e-5, 1e-5) if qdt == torch.float32 else (1e-2, 1e-4)
    for i, case in enumerate(CARD_CASES):
        q, k, v, qp, kp = _card_inputs(card, case, qdt, kvdt, i)
        kw = dict(window=case[8], softcap=case[9])
        before = FA.launches["flash_attention"]
        out, lse = ops.flash_attention(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        assert FA.launches["flash_attention"] == before + 1
        want = FA.flash_attention_plain(q, k, v, qp, kp, **kw)
        assert out.dtype == qdt and out.shape == q.shape
        d_out = float((out.float() - want[0].float()).abs().max())
        d_lse = float((lse - want[1]).abs().max())
        assert d_out <= tol[0] and d_lse <= tol[1], (case, d_out, d_lse)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_cannot_take(card):
    q, k, v, qp, kp = _card_inputs(card, (1, 4, 8, 2, 1, 12, 0, 0, 0, 0.0),
                                   torch.bfloat16, torch.float32, 0)
    with pytest.raises(ValueError, match="multiples of 8"):
        FA.flash_attention_cuda(q, k, v, qp, kp)
