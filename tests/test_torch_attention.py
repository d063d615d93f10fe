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
both packages.  The split path's plain twin (per-split partials, then the
merge) equals the unsplit plain version within 1e-6, and
``decode_splits`` / ``split_plan`` are checked as pure functions.  The
backward: ``flash_attention_bwd_plain`` equals ``jax.vjp`` of the
reference's ``fused_attention`` region over ``jnp.repeat``-ed K/V (dk / dv
summed over each group) within 1e-5 in float32 — G = 1 / 2 / 4, window,
softcap, Sk past ``KV_CHUNK``, sentinel-padded keys, rows that see nothing
— and the unfused ``_flash_attend``'s ``jax.grad``; the autograd function
``layers.fused_attention`` equals autograd through a dense attention, and
passes ``gradcheck`` in float64.  Tests marked ``cuda``
hold the kernels to the plain versions on the card; the reference (which
needs jax) comes in through a fixture, so they collect where jax is not
installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
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
# The split (flash-decoding) path: plain twin and split counts
# ---------------------------------------------------------------------------
#: (B, Sq, Sk, H, KV, hd, q0, sentinel tail, window, softcap, n_split,
#: split_tiles); q0 < 0 puts every query at Sk - 1 (decode at the end)
SPLIT_CASES = {
    # the second slot all sentinel: its splits all see nothing
    "all_sentinel_slot": (2, 1, 700, 8, 2, 16, -1, 700, 0, 0.0, 11, 1),
    # queries at 300: splits 5 .. 10 lie in the causal future, empty
    "empty_future_splits": (2, 1, 700, 8, 2, 16, 300, 0, 0, 0.0, 6, 2),
    # the window leaves only the last splits anything to see
    "window": (3, 1, 1500, 6, 2, 16, -1, 200, 100, 0.0, 8, 3),
    "softcap": (2, 3, 900, 4, 1, 32, 700, 50, 0, 5.0, 5, 3),
    "window_softcap_g3": (2, 2, 400, 6, 2, 24, 390, 0, 37, 2.5, 7, 1),
    "one_split": (2, 1, 100, 4, 2, 16, -1, 30, 0, 0.0, 1, 2),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_plain_matches_plain(name):
    """Per-split (m, l, acc) over contiguous key ranges, merged, equal the
    unsplit plain version within 1e-6 in float32 (only the order of the
    sums differs); a split that sees nothing contributes nothing, and a
    slot that sees no key gives 0 and the plain version's lse."""
    b, sq, sk, h, kv, hd, q0, tail, window, softcap, n, per = \
        SPLIT_CASES[name]
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(
        11, b, sq, sk, h, kv, hd, q0=sk - 1 if q0 < 0 else q0, tail=tail))
    kw = dict(window=window, softcap=softcap)
    acc, ml = FA.split_partials_plain(q, k, v, qp, kp, n_split=n,
                                      split_tiles=per, **kw)
    assert acc.shape == (n, b, sq, h, hd) and ml.shape == (n, b, h, sq, 2)
    got = FA.combine_plain(acc, ml, q.dtype)
    want = FA.flash_attention_plain(q, k, v, qp, kp, **kw)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0,
                               atol=1e-6)
    if tail == sk:                          # the all-sentinel slot
        assert not got[0][-1].any()
        assert (ml[:, -1, ..., 0] == FA.NEG).all()
        assert not ml[:, -1, ..., 1].any()


def _excess(got, want, tol) -> float:
    """max |got - want| / tol: at most 1 passes."""
    return float(((got.float() - want.float()).abs() / tol).max())


def test_split_plain_bf16_is_the_split_of_the_plain_bf16():
    """bf16 q: P is rounded at each split's own running max, so the split
    path's out moves within ``bf16_out_tolerance`` of the unsplit one, as
    the kernel is held on the card; lse within 1e-5."""
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(
        12, 4, 1, 1000, 8, 2, 16, q0=999, tail=300))
    q = q.bfloat16()
    n, per = FA.decode_splits(4, 2, 1000, 132)
    got = FA.flash_attention_split_plain(q, k, v, qp, kp, n_split=n,
                                         split_tiles=per)
    want = FA.flash_attention_plain(q, k, v, qp, kp)
    assert got[0].dtype == torch.bfloat16
    assert _excess(got[0], want[0], FA.bf16_out_tolerance(
        q, k, v, qp, kp, want)) <= 1.0
    assert float((got[1] - want[1]).abs().max()) <= 1e-5


@pytest.mark.parametrize("slot", [0, 1])
def test_bf16_tolerance_catches_a_wrong_v_tile(slot):
    """The bf16 out tolerance passes the split path (P rounded at other
    running maxima) and fails it when one split reads the wrong V tile of
    one slot — a fault lse cannot see."""
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(
        13, 2, 1, 2048, 8, 2, 80, q0=2047))
    q, qp = q.bfloat16(), torch.tensor([[2047], [1023]], dtype=torch.int32)
    kp = torch.where(kp <= qp, kp, SENTINEL).int()
    want = FA.flash_attention_plain(q, k, v, qp, kp)
    tol = FA.bf16_out_tolerance(q, k, v, qp, kp, want)
    n, per = FA.decode_splits(2, 2, 2048, 132)
    good = FA.flash_attention_split_plain(q, k, v, qp, kp, n_split=n,
                                          split_tiles=per)
    assert _excess(good[0], want[0], tol) <= 0.5
    wrong = v.clone()
    wrong[slot, 640:704] = v[slot, 704:768]
    bad = FA.flash_attention_split_plain(q, k, wrong, qp, kp, n_split=n,
                                         split_tiles=per)
    assert _excess(bad[0], want[0], tol) > 2.0


@pytest.mark.parametrize("b,kvh,sk,sms", [
    (4, 8, 4096, 132), (4, 8, 700, 132), (1, 1, 1000, 132), (3, 2, 65, 132),
    (1, 8, 64, 132), (64, 8, 4096, 132), (200, 8, 4096, 132),
    (2, 4, 100_000, 114), (4, 8, 4096, 1)])
def test_decode_splits_cover_every_tile_once(b, kvh, sk, sms):
    n, per = FA.decode_splits(b, kvh, sk, sms)
    tiles = -(-sk // FA.TILE_KEYS)
    ranges = FA.split_ranges(sk, n, per)
    assert len(ranges) == n >= 1 and per >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == sk
    assert all(r0[1] == r1[0] for r0, r1 in zip(ranges, ranges[1:]))
    # no split under one tile; every boundary on a tile boundary
    assert all(hi > lo for lo, hi in ranges)
    assert all(lo % FA.TILE_KEYS == 0 for lo, _ in ranges)
    assert n <= tiles


def test_decode_splits_fill_the_card_at_the_serving_decode_shape():
    """qwen3-4b decode on 4 slots of 4096: 32 (slot, kv head) pairs need
    splits to put at least 2 blocks on each of 132 SMs; a call with enough
    blocks of its own is not split."""
    n, per = FA.decode_splits(4, 8, 4096, 132)
    assert 4 * 8 * n >= 2 * 132
    assert per * FA.TILE_KEYS * (n - 1) < 4096 <= per * FA.TILE_KEYS * n
    assert FA.decode_splits(600, 8, 4096, 132) == (1, 64)


def test_split_plan_splits_only_calls_that_fit_one_block():
    """The wrapper's split: decode and chunks of up to 64 rows (Sq * H /
    KV) take ``decode_splits``; a longer call walks every tile at once."""
    assert FA.split_plan(4, 1, 32, 8, 4096, 132) == \
        FA.decode_splits(4, 8, 4096, 132)
    assert FA.split_plan(2, 16, 32, 8, 4096, 132) == \
        FA.decode_splits(2, 8, 4096, 132)
    assert FA.split_plan(1, 17, 32, 8, 4096, 132) == (1, 64)
    assert FA.split_plan(1, 2048, 32, 8, 4097, 132) == (1, 65)


def test_build_hash_follows_the_headers(tmp_path, monkeypatch):
    """An edited ``csrc`` header changes every library's name, so a stale
    library is never loaded; so does an edited source."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// one\n")
    before = build.lib_path("k")
    assert build.lib_path("k") == before
    (tmp_path / "a.cuh").write_text("// two\n")
    edited = build.lib_path("k")
    assert edited != before
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// more\n')
    assert build.lib_path("k") not in (before, edited)


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
    # the split path: B = 4 over 4096 slots, the last slot all sentinel
    (4, 1, 4096, 32, 8, 80, 4095, 4096, 0, 0.0),
    (4, 1, 4096, 32, 8, 80, 4095, 0, 300, 0.0),    # windowed decode
    (3, 1, 2000, 6, 2, 80, 1999, 700, 0, 0.0),     # G = 3
    (2, 5, 3000, 32, 8, 80, 2995, 100, 0, 30.0),   # a 5-token chunk, softcap
    # prefill: many ring stages, ragged Sk, 128-row blocks
    (1, 1000, 1333, 32, 8, 80, 333, 0, 0, 0.0),
    (2, 517, 2100, 16, 4, 64, 1500, 90, 0, 0.0),
    (1, 640, 640, 8, 8, 128, 0, 0, 200, 0.0),       # hd 128, window
    # more tiles than one visibility pass flags (wgmma blocks: 96; hd 16
    # blocks: 32)
    (1, 100, 7000, 8, 2, 64, 6900, 30, 0, 0.0),
    (1, 40, 2500, 4, 2, 16, 2460, 0, 0, 0.0),
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
    bf16 q: out within ``bf16_out_tolerance`` per element (P rounded to
    bf16 at other running maxima, out rounded once), lse within 1e-4
    (float32 sums of the same products)."""
    for i, case in enumerate(CARD_CASES):
        q, k, v, qp, kp = _card_inputs(card, case, qdt, kvdt, i)
        kw = dict(window=case[8], softcap=case[9])
        b, sq, sk, h, kv = case[:5]
        split = FA.split_plan(b, sq, h, kv, sk, FA.sm_count(card))[0] > 1
        before = dict(FA.launches)
        out, lse = ops.flash_attention(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        assert FA.launches["flash_attention"] == \
            before["flash_attention"] + 1
        assert FA.launches["flash_attention_combine"] == \
            before["flash_attention_combine"] + split
        want = FA.flash_attention_plain(q, k, v, qp, kp, **kw)
        assert out.dtype == qdt and out.shape == q.shape
        d_out = float((out.float() - want[0].float()).abs().max())
        d_lse = float((lse - want[1]).abs().max())
        if qdt == torch.float32:
            assert d_out <= 1e-5 and d_lse <= 1e-5, (case, d_out, d_lse)
        else:
            excess = _excess(out, want[0], FA.bf16_out_tolerance(
                q, k, v, qp, kp, want, **kw))
            assert excess <= 1.0 and d_lse <= 1e-4, (case, d_out, excess,
                                                     d_lse)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_cannot_take(card):
    q, k, v, qp, kp = _card_inputs(card, (1, 4, 8, 2, 1, 12, 0, 0, 0, 0.0),
                                   torch.bfloat16, torch.float32, 0)
    with pytest.raises(ValueError, match="multiples of 8"):
        FA.flash_attention_cuda(q, k, v, qp, kp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_combine_kernel_matches_plain_on_card(dtype, card):
    """The merge alone, on the plain twin's partials (an all-sentinel slot
    among them): out within the rounding of its type, lse within 1e-5."""
    q, k, v, qp, kp = _card_inputs(card, (4, 1, 2000, 32, 8, 80, 1999, 2000,
                                          100, 0.0), dtype, torch.float32, 5)
    acc, ml = FA.split_partials_plain(q, k, v, qp, kp, n_split=8,
                                      split_tiles=4, window=100)
    before = FA.launches["flash_attention_combine"]
    got = FA.combine_cuda(acc, ml, dtype)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention_combine"] == before + 1
    want = FA.combine_plain(acc, ml, dtype)
    if dtype == torch.bfloat16:      # the same partials: out's rounding
        tol = 1e-3 + 2.0 ** -6 * want[0].float().abs()
        assert _excess(got[0], want[0], tol) <= 1.0
    else:
        assert float((got[0].float() - want[0].float()).abs().max()) <= 1e-5
    assert float((got[1] - want[1]).abs().max()) <= 1e-5
    assert not got[0][-1].any()


# ---------------------------------------------------------------------------
# The backward of the region: plain twin vs the reference, autograd
# ---------------------------------------------------------------------------
#: (B, Sq, Sk, H, KV, hd, q0, sentinel tail, window, softcap)
BWD_CASES = {
    "g1": (2, 48, 48, 4, 4, 16, 0, 0, 0, 0.0),
    "g2_window": (2, 40, 40, 4, 2, 16, 0, 0, 9, 0.0),
    "g4_softcap": (1, 56, 56, 8, 2, 16, 0, 0, 0, 5.0),
    "g4_window_softcap": (2, 33, 33, 4, 1, 8, 0, 0, 7, 2.5),
    # Sk past KV_CHUNK (1024) and not a multiple of it, with padded keys
    "long_ragged_sentinel": (2, 21, 1100, 4, 2, 16, 1079, 150, 0, 0.0),
    # a decode row and rows before every key (they see nothing)
    "decode_sentinel": (3, 1, 80, 4, 2, 16, 49, 30, 0, 0.0),
    "rows_see_nothing": (2, 6, 20, 2, 1, 16, -3, 0, 0, 0.0),
}


def _dout(seed, q):
    return np.random.default_rng(seed).normal(0, 1, q.shape).astype(q.dtype)


def _reference_vjp(J, q, k, v, qp, kp, do, window, softcap):
    """jax.vjp of the region over K/V repeated to the query heads: the
    cotangents of the unrepeated K/V are summed over each group."""
    import jax
    rep = q.shape[2] // k.shape[2]
    jnp = J.jnp

    def f(q, k, v):
        return J.layers.fused_attention(
            window, softcap, q, jnp.repeat(k, rep, axis=2),
            jnp.repeat(v, rep, axis=2), jnp.asarray(qp), jnp.asarray(kp))

    _out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_bwd(q, k, v, qp, kp, do, **kw):
    t = [torch.from_numpy(x) for x in (q, k, v, qp, kp, do)]
    out, lse = ops.flash_attention(*t[:5], **kw)
    return ops.flash_attention_bwd(*t[:5], out, lse, t[5], **kw)


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_bwd_plain_matches_reference_vjp(name, J):
    b, sq, sk, h, kv, hd, q0, tail, window, softcap = BWD_CASES[name]
    q, k, v, qp, kp = _case(21, b, sq, sk, h, kv, hd, q0=q0, tail=tail)
    do = _dout(22, q)
    want = _reference_vjp(J, q, k, v, qp, kp, do, window, softcap)
    got = _port_bwd(q, k, v, qp, kp, do, window=window, softcap=softcap)
    for g, w, shape in zip(got, want, (q.shape, k.shape, v.shape),
                           strict=True):
        assert g.shape == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    if name == "rows_see_nothing":          # queries at -3 .. 2 over keys
        assert not got[0][:, :3].any()      # 0 .. 19: the first 3 see none


def test_bwd_plain_bf16_matches_reference_bf16(J):
    """bf16 operands: the same bf16 products (dout * out, p and ds rounded
    before their products) with float32 sums in another order; each query
    head's dk / dv is rounded to bf16 before the group sum in both.  The
    gradients differ by a few bf16 roundings of values of size ~|g|:
    within 2^-6 of the largest entry of each."""
    import ml_dtypes
    b, sq, sk, h, kv, hd = 2, 40, 40, 4, 2, 16
    q, k, v, qp, kp = _case(23, b, sq, sk, h, kv, hd,
                            dtype=ml_dtypes.bfloat16)
    do = _dout(24, q.astype(np.float32)).astype(ml_dtypes.bfloat16)
    want = _reference_vjp(J, q, k, v, qp, kp, do, 0, 0.0)
    bf = lambda x: torch.from_numpy(x.view(np.int16)).view(  # noqa: E731
        torch.bfloat16)
    tq, tk, tv, tdo = (bf(x) for x in (q, k, v, do))
    qp_t, kp_t = torch.from_numpy(qp), torch.from_numpy(kp)
    out, lse = ops.flash_attention(tq, tk, tv, qp_t, kp_t)
    got = ops.flash_attention_bwd(tq, tk, tv, qp_t, kp_t, out, lse, tdo)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.bfloat16
        w = w.astype(np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2.0 ** -6 * np.abs(w).max())


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (13, 0.0), (0, 3.0)])
def test_bwd_plain_matches_unfused_grad(window, softcap, J):
    """The same gradients as jax.grad through the unfused jnp path."""
    import jax
    q, k, v, qp, kp = _case(25, 2, 50, 50, 4, 2, 16)
    do = _dout(26, q)
    jnp, rep = J.jnp, 2

    def loss(q, k, v):
        out = J.layers._flash_attend(
            q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
            jnp.asarray(qp), jnp.asarray(kp), sliding_window=window,
            softcap=softcap)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    got = _port_bwd(q, k, v, qp, kp, do, window=window, softcap=softcap)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def _dense_attention(q, k, v, qp, kp, window=0, softcap=0.0):
    """Attention as one masked softmax over the repeated heads, for
    autograd to differentiate."""
    rep = q.shape[2] // k.shape[2]
    kr, vr = (x.repeat_interleave(rep, 2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(q.shape[-1])
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    keep = qp[:, None, :, None] >= kp[:, None, None, :]
    if window > 0:
        keep &= qp[:, None, :, None] - kp[:, None, None, :] < window
    p = torch.softmax(torch.where(keep, s, -torch.inf), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 2.0)])
def test_fused_attention_function_matches_autograd(window, softcap):
    from repro_torch.models import layers as TL
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(
        27, 2, 24, 24, 4, 2, 16))
    do = torch.from_numpy(_dout(28, q.numpy()))
    grads = []
    for fn in (lambda *a: TL.fused_attention(window, softcap, *a, qp, kp),
               lambda *a: _dense_attention(*a, qp, kp, window, softcap)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        grads.append(torch.autograd.grad(out, leaves, do))
        grads[-1] = (*grads[-1], out.detach())
    for g, w in zip(*grads, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_fused_attention_gradcheck_float64():
    """float64 end to end (the plain twins sum in float64 there), a window
    and a softcap, G = 2: gradcheck's finite differences agree."""
    from repro_torch.models import layers as TL
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(
        29, 1, 6, 6, 2, 1, 8, dtype=np.float64))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda *a: TL.fused_attention(4, 3.0, *a, qp, kp), leaves)


def test_bwd_wrapper_wants_cuda_tensors():
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(30, 1, 4, 6, 2, 1,
                                                          16))
    out, lse = FA.flash_attention_plain(q, k, v, qp, kp)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FA.flash_attention_bwd_cuda(q, k, v, qp, kp, out.contiguous(), lse,
                                    q)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, qp, kp, out, lse[:, :1], q)


def test_grad_excess_catches_a_wrong_tile():
    """The bf16 tolerance of the card checks (``grad_excess``): the plain
    twin passes against itself, a gradient with one wrong 64-key tile of
    dv fails."""
    q, k, v, qp, kp = (torch.from_numpy(x) for x in _case(
        31, 1, 128, 128, 4, 2, 16))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0)
                     ).to(torch.bfloat16)
    out, lse = FA.flash_attention_plain(q, k, v, qp, kp)
    plain = FA.flash_attention_bwd_plain(q, k, v, qp, kp, out, lse, do)
    exact = FA.flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v)), qp, kp, out.double(), lse.double(),
        do.double())
    for g, e in zip(plain, exact, strict=True):
        assert FA.grad_excess(g, g, e) == 0.5
    wrong = plain[2].clone()
    wrong[:, 64:] = 0
    assert FA.grad_excess(wrong, plain[2], exact[2]) > 1.0


# ---------------------------------------------------------------------------
# A CPU model of the card backward's order of sums (bf16, hd 33..128)
# ---------------------------------------------------------------------------
def _key_tile_range(kp, lo, hi):
    """(smallest, largest) position of keys [lo, hi) of a position row,
    the kernel's ``PAD_POS`` (``SENTINEL``) past its end."""
    p = kp[lo:hi].tolist() + [SENTINEL] * max(0, hi - kp.numel())
    return min(p), max(p)


def _tiles_see(kr, qr, window):
    """The kernel's tile skip: may some query in ``qr`` see a key in
    ``kr``?"""
    (kmin, kmax), (qmin, qmax) = kr, qr
    if kmin > kmax or qmin > qmax or kmin > qmax:
        return False
    return not (window > 0 and kmax <= qmin - window)


def _bwd_tiled_model(q, k, v, qp, kp, out, lse, do, *, window=0,
                     softcap=0.0, key_tile=128):
    """The order of ``bwd_wg``'s sums, on the CPU: work items (batch, kv
    head, ``key_tile`` keys) walk the 64-query tiles some query of which
    may see some key of the item, the last tile first, the group's G query
    heads inner; dK and dV of the item summed in float32 in that order and
    rounded once; each step's dQ partial dS . K (float32) added into a
    float32 sum per (batch, head, query tile) in ascending key-tile order,
    then scaled and rounded once.  p and dS are rounded to q's type before
    their products, as in the kernel."""
    cdt = q.dtype
    f = torch.float64 if cdt == torch.float64 else torch.float32
    b_, sq, h_, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp, scale, bq = h_ // kvh, 1.0 / np.sqrt(hd), 64
    delta = (do * out).to(f).sum(-1)                      # (B, Sq, H)
    kf, vf = k.to(cdt).to(f), v.to(cdt).to(f)
    qf, dof = q.to(f), do.to(f)
    dk, dv = torch.zeros(k.shape, dtype=f), torch.zeros(v.shape, dtype=f)
    parts = {}                   # (b, h, query tile) -> [(key tile, part)]
    n_qt, n_kt = -(-sq // bq), -(-sk // key_tile)
    for b in range(b_):
        qr = [(int(qp[b, i * bq:(i + 1) * bq].min()),
               int(qp[b, i * bq:(i + 1) * bq].max())) for i in range(n_qt)]
        for kh in range(kvh):
            for jt in range(n_kt):
                ks = slice(jt * key_tile, min(sk, (jt + 1) * key_tile))
                kr = _key_tile_range(kp[b], ks.start, ks.start + key_tile)
                acc_k = torch.zeros((ks.stop - ks.start, hd), dtype=f)
                acc_v = torch.zeros_like(acc_k)
                for i in reversed(range(n_qt)):
                    if not _tiles_see(kr, qr[i], window):
                        continue
                    qs = slice(i * bq, min(sq, (i + 1) * bq))
                    keep = qp[b, qs, None] >= kp[b, None, ks]
                    if window > 0:
                        keep &= qp[b, qs, None] - kp[b, None, ks] < window
                    for g in range(grp):
                        hh = kh * grp + g
                        s = qf[b, qs, hh] @ kf[b, ks, kh].T * scale
                        dsm = 1.0
                        if softcap > 0.0:
                            t = torch.tanh(s / softcap)
                            s, dsm = softcap * t, 1.0 - t * t
                        p = torch.where(keep, torch.exp(
                            s - lse[b, hh, qs, None].to(f)), 0.0)
                        dp = dof[b, qs, hh] @ vf[b, ks, kh].T
                        ds = p * (dp - delta[b, qs, hh, None]) * dsm
                        p, ds = p.to(cdt).to(f), ds.to(cdt).to(f)
                        acc_v += p.T @ dof[b, qs, hh]
                        acc_k += ds.T @ qf[b, qs, hh]
                        parts.setdefault((b, hh, i), []).append(
                            (jt, ds @ kf[b, ks, kh]))
                dk[b, ks, kh] = acc_k * scale
                dv[b, ks, kh] = acc_v
    dq = torch.zeros(q.shape, dtype=f)
    for (b, hh, i), ps in parts.items():
        acc = torch.zeros_like(ps[0][1])
        for _jt, part in sorted(ps, key=lambda x: x[0]):
            acc = acc + part
        dq[b, i * bq:i * bq + acc.shape[0], hh] = acc * scale
    return dq.to(cdt), dk.to(k.dtype), dv.to(v.dtype)


#: BWD_CASES, and shapes with several query tiles and key tiles: Sk not a
#: multiple of either key tile, windows starting inside a tile
MODEL_CASES = {
    **BWD_CASES,
    "tiles_window": (1, 200, 200, 4, 2, 16, 0, 0, 70, 0.0),
    "tiles_ragged_sentinel": (2, 130, 300, 4, 1, 8, 170, 20, 0, 0.0),
    "tiles_window_softcap": (1, 150, 330, 2, 2, 16, 180, 0, 100, 4.0),
}


@pytest.mark.parametrize("key_tile", [64, 128])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_bwd_tiled_model_matches_reference_vjp(name, key_tile, J):
    """float32: the card kernel's order of sums gives the reference's
    gradients within 1e-5."""
    b, sq, sk, h, kv, hd, q0, tail, window, softcap = MODEL_CASES[name]
    q, k, v, qp, kp = _case(41, b, sq, sk, h, kv, hd, q0=q0, tail=tail)
    do = _dout(42, q)
    want = _reference_vjp(J, q, k, v, qp, kp, do, window, softcap)
    t = [torch.from_numpy(x) for x in (q, k, v, qp, kp, do)]
    out, lse = FA.flash_attention_plain(*t[:5], window=window,
                                        softcap=softcap)
    got = _bwd_tiled_model(*t[:5], out, lse, t[5], window=window,
                           softcap=softcap, key_tile=key_tile)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("key_tile", [64, 128])
@pytest.mark.parametrize("name", ["tiles_window", "tiles_ragged_sentinel",
                                  "tiles_window_softcap"])
def test_bwd_tiled_model_bf16_within_the_card_tolerance(name, key_tile):
    """bf16: the model's gradients meet the card check's tolerance
    (``grad_excess`` <= 1 against a float64 evaluation, next to the bf16
    plain twin)."""
    b, sq, sk, h, kv, hd, q0, tail, window, softcap = MODEL_CASES[name]
    x = [torch.from_numpy(a) for a in _case(43, b, sq, sk, h, kv, hd, q0=q0,
                                            tail=tail)]
    q, k, v = (a.to(torch.bfloat16) for a in x[:3])
    qp, kp = x[3], x[4]
    do = torch.from_numpy(_dout(44, x[0].numpy())).to(torch.bfloat16)
    kw = dict(window=window, softcap=softcap)
    out, lse = FA.flash_attention_plain(q, k, v, qp, kp, **kw)
    args = (q, k, v, qp, kp, out, lse, do)
    got = _bwd_tiled_model(*args, **kw, key_tile=key_tile)
    plain = FA.flash_attention_bwd_plain(*args, **kw)
    exact = FA.flash_attention_bwd_plain(
        *(a.double() if a.is_floating_point() else a for a in args), **kw)
    for g, w, e in zip(got, plain, exact, strict=True):
        assert g.dtype == torch.bfloat16
        assert FA.grad_excess(g, w, e) <= 1.0


def test_bwd_ablation_edits_match_the_kernel_source():
    """``python -m repro_torch.bwd_ablation`` builds copies of the backward
    source with parts taken out by text edits: every edit still finds its
    line, so a change to the kernel cannot silently void the tool."""
    from repro_torch import bwd_ablation
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    for name, edits in bwd_ablation.VARIANTS.items():
        for old, _new in edits:
            assert old in src, (name, old)


# ---------------------------------------------------------------------------
# On the card: the backward kernel == its plain twin
# ---------------------------------------------------------------------------
#: (B, Sq, Sk, H, KV, hd, q0, sentinel tail, window, softcap)
BWD_CARD_CASES = (
    (2, 64, 64, 4, 4, 16, 0, 0, 0, 0.0),           # G = 1, one tile
    (2, 100, 300, 8, 2, 64, 200, 37, 37, 30.0),    # ragged, window, softcap
    (1, 130, 200, 4, 4, 128, 70, 17, 0, 5.0),      # hd 128
    (3, 77, 1000, 6, 2, 80, 923, 17, 0, 0.0),      # G = 3, hd 80
    (2, 256, 256, 32, 8, 80, 0, 0, 0, 0.0),        # the training heads
    (1, 9, 1000, 3, 1, 16, 991, 0, 0, 0.0),        # G = 3, few queries
    (2, 20, 45, 4, 2, 8, 25, 10, 5, 0.0),          # hd 8 (padded to 16)
    (1, 3, 20, 2, 1, 16, -10, 0, 0, 0.0),          # rows before every key
    (2, 517, 600, 16, 4, 64, 83, 90, 0, 0.0),      # ragged tiles, hd 64
    (1, 200, 200, 8, 2, 32, 0, 0, 50, 0.0),        # hd 32, window
    (2, 1024, 1024, 32, 8, 128, 0, 0, 0, 0.0),     # hd 128, the 8b heads
    (1, 512, 512, 24, 24, 64, 0, 0, 0, 0.0),       # MHA (G = 1), hd 64
    (1, 1024, 1024, 8, 2, 64, 0, 0, 300, 0.0),     # a window cutting tiles
    # more work items (8 x 4 kv heads x 8 key tiles) than resident blocks
    (8, 1024, 1024, 8, 4, 80, 0, 0, 0, 0.0),
)


def _card_bwd_inputs(card, case, dt, seed):
    q, k, v, qp, kp = _card_inputs(card, case, dt, dt, seed)
    g = torch.Generator(device=card)
    g.manual_seed(seed + 1000)
    do = torch.randn(q.shape, generator=g, device=card).to(dt)
    out, lse = FA.flash_attention_plain(q, k, v, qp, kp, window=case[8],
                                        softcap=case[9])
    return q, k, v, qp, kp, out.contiguous(), lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_flash_attention_bwd_kernel_matches_plain_on_card(dt, card):
    """float32: within 1e-5 of the plain twin's largest entry per
    gradient.  bf16: ``grad_excess`` <= 1 against a float64 evaluation
    (the kernel's error at most twice the bf16 twin's own).  Two runs are
    bit-identical (no floating-point atomics; the one-pass kernel's dQ sums
    run in a fixed order, also when work items outnumber resident
    blocks)."""
    for i, case in enumerate(BWD_CARD_CASES):
        args = _card_bwd_inputs(card, case, dt, i)
        kw = dict(window=case[8], softcap=case[9])
        before = FA.launches["flash_attention_bwd"]
        got = ops.flash_attention_bwd(*args, **kw)
        again = FA.flash_attention_bwd_cuda(*args, **kw)
        torch.cuda.synchronize()
        assert FA.launches["flash_attention_bwd"] == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again,
                                                     strict=True)), case
        plain = FA.flash_attention_bwd_plain(*args, **kw)
        if dt == torch.float32:
            for g, w in zip(got, plain, strict=True):
                err = float((g - w).abs().max())
                assert err <= 1e-5 * max(float(w.abs().max()), 1e-30), \
                    (case, err)
        else:
            exact = FA.flash_attention_bwd_plain(
                *(x.double() if x.is_floating_point() else x for x in args),
                **kw)
            for g, w, e in zip(got, plain, exact, strict=True):
                assert FA.grad_excess(g, w, e) <= 1.0, case


@pytest.mark.cuda
def test_fused_attention_trains_through_the_kernels_on_card(card):
    """The autograd function on CUDA tensors: one forward and one backward
    kernel launch, gradients equal to the plain path's on the same
    inputs (float32, within 1e-5 of the largest entry)."""
    from repro_torch.models import layers as TL
    q, k, v, qp, kp = _card_inputs(card, (2, 150, 150, 8, 2, 80, 0, 0, 0,
                                          0.0), torch.float32,
                                   torch.float32, 7)
    do = torch.randn(q.shape, device=card)
    before = dict(FA.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(TL.fused_attention(0, 0.0, *leaves, qp, kp),
                              leaves, do)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == before["flash_attention"] + 1
    assert FA.launches["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    cpu = [x.cpu().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(TL.fused_attention(0, 0.0, *cpu, qp.cpu(),
                                                  kp.cpu()), cpu, do.cpu())
    for g, w in zip(got, want, strict=True):
        assert float((g.cpu() - w).abs().max()) <= \
            1e-5 * float(w.abs().max())


@pytest.mark.cuda
def test_decode_step_takes_sliced_positions_on_card(card):
    """``decode_step`` with its positions sliced from a longer row
    (``pos[:, 9:10]``: contiguous, but 36 bytes past a 16-byte boundary,
    where the kernel reads aligned rows) gives the logits of a fresh
    positions tensor, both through the kernel."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
                      param_dtype="float32", compute_dtype="float32")
    g = torch.Generator(device=card)
    g.manual_seed(0)
    params = T.init_params(g, cfg)
    toks = torch.randint(2, cfg.vocab, (1, 10), generator=g, device=card)
    pos = torch.arange(10, dtype=torch.int32, device=card)[None]
    runs = []
    for step in (pos[:, 9:10], torch.full_like(pos[:, :1], 9)):
        caches = T.init_caches(cfg, 1, 16, dtype=torch.float32, device=card)
        T.decode_step(params, cfg, toks[:, :9], caches, pos[:, :9])
        before = FA.launches["flash_attention"]
        logits, _ = T.decode_step(params, cfg, toks[:, 9:], caches, step)
        assert FA.launches["flash_attention"] == before + cfg.n_layers
        runs.append(logits)
    assert pos[:, 9:10].data_ptr() % 16
    assert torch.equal(runs[0], runs[1])
