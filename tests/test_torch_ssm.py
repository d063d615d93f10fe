"""The port's Mamba2 / SSD module (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``).

The reference's parameters (``init_ssm``) cross over as numpy; inputs are
made with numpy.  Float32 throughout, at the SSM configs of
``tests/test_models.py`` (chunk 8) and the ``.smoke()`` configs of
mamba2-780m and hymba-1.5b (chunk 16): ``_segsum`` exactly (its -inf
pattern too), ``_ssd_chunked`` (y and the final state) and ``apply_ssm``
on the prefill, prefill-into-a-cache, decode and right-padded ``valid``
paths within 1e-5 (float32 products summed in another order), the caches
written in place.  Then the reference's own properties on the port: the
chunked scan equals the step-by-step recurrence, and a right-padded
prefill leaves the state and conv window of the unpadded one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import ssm as RSSM
from repro.models.config import ModelConfig as RModelConfig
from repro_torch import configs as TC
from repro_torch.kernels import ssd as TSSD
from repro_torch.models import ssm as TSSM
from repro_torch.models.config import ModelConfig as TModelConfig

#: tests/test_models.py's "ssm" and "hybrid" configs
_BASE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=128, head_dim=16, ssm_chunk=8,
             param_dtype="float32", compute_dtype="float32")
_KW = {"models_ssm": dict(n_heads=0, n_kv_heads=0, d_ff=0, block_type="ssm",
                          ssm_state=8, ssm_head_dim=16),
       "models_hybrid": dict(block_type="hybrid", ssm_state=8,
                             ssm_head_dim=16, ssm_expand=1)}
CFGS = ["models_ssm", "models_hybrid", "mamba2-780m", "hymba-1.5b"]


def _cfgs(name):
    if name in _KW:
        kw = {**_BASE, **_KW[name]}
        return RModelConfig(**kw), TModelConfig(**kw)
    return RC.get_config(name).smoke(), TC.get_config(name).smoke()


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _params(name, seed=0):
    rcfg, tcfg = _cfgs(name)
    rp = RSSM.init_ssm(jax.random.PRNGKey(seed), rcfg)
    return rcfg, rp, tcfg, _torch(jax.tree.map(np.asarray, rp))


def _cache(cfg, b, rng):
    """A non-zero cache (state and conv window), numpy."""
    c = jax.tree.map(np.asarray, RSSM.init_ssm_cache(cfg, b))
    return {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
            for k, v in c.items()}


# ---------------------------------------------------------------------------
# _segsum and _ssd_chunked
# ---------------------------------------------------------------------------
def test_segsum_matches_reference():
    x = np.random.default_rng(0).normal(-0.3, 0.2, (2, 3, 8)).astype(
        np.float32)
    want = np.asarray(RSSM._segsum(jnp.asarray(x)))
    got = TSSD._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 8), (16, 16), (24, 8),
                                     (8, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    rng = np.random.default_rng(s + chunk)
    b, nh, hd, n = 2, 3, 5, 4
    x = rng.normal(0, 1, (b, s, nh, hd)).astype(np.float32)
    dtv = rng.uniform(0.01, 0.2, (b, s, nh)).astype(np.float32)
    a_log = np.log(np.linspace(1, 16, nh)).astype(np.float32)
    bm, cm = (rng.normal(0, 1, (b, s, n)).astype(np.float32)
              for _ in range(2))
    want_y, want_st = RSSM._ssd_chunked(*map(jnp.asarray,
                                             (x, dtv, a_log, bm, cm)), chunk)
    got_y, got_st = TSSD._ssd_chunked(*map(torch.from_numpy,
                                           (x, dtv, a_log, bm, cm)), chunk)
    _close(got_y, want_y, 1e-5)
    _close(got_st, want_st, 1e-5)


# ---------------------------------------------------------------------------
# apply_ssm: prefill, prefill into a cache, decode, valid
# ---------------------------------------------------------------------------
def test_init_ssm_follows_the_reference():
    rcfg, rp, tcfg, _tp = _params("mamba2-780m")
    tp = TSSM.init_ssm(torch.Generator().manual_seed(0), tcfg)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rp)
    got = {k: ({n: (tuple(t.shape), str(t.dtype).split(".")[1])
                for n, t in v.items()} if isinstance(v, dict)
               else (tuple(v.shape), str(v.dtype).split(".")[1]))
           for k, v in tp.items()}
    assert got == want
    for k in ("a_log", "d_skip", "conv_b"):
        _close(tp[k], rp[k], 1e-6)
    dt0 = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1001


@pytest.mark.parametrize("name", CFGS)
def test_apply_ssm_prefill_matches_reference(name):
    rcfg, rp, tcfg, tp = _params(name, 1)
    rng = np.random.default_rng(2)
    u = rng.normal(0, 1, (2, 16, rcfg.d_model)).astype(np.float32)
    want, _ = RSSM.apply_ssm(rp, rcfg, jnp.asarray(u))
    got, cache = TSSM.apply_ssm(tp, tcfg, torch.from_numpy(u))
    assert cache is None
    _close(got, want, 1e-5)
    # into a cache: the state and the conv window written in place
    c0 = _cache(rcfg, 2, rng)
    want, rc = RSSM.apply_ssm(rp, rcfg, jnp.asarray(u),
                              ssm_cache=jax.tree.map(jnp.asarray, c0))
    tc = _torch(c0)
    state, conv = tc["state"], tc["conv"]
    got, tc2 = TSSM.apply_ssm(tp, tcfg, torch.from_numpy(u), ssm_cache=tc)
    assert tc2 is tc and tc2["state"] is state and tc2["conv"] is conv
    _close(got, want, 1e-5)
    _close(state, rc["state"], 1e-5)
    _close(conv, rc["conv"], 1e-5)


@pytest.mark.parametrize("name", CFGS)
def test_apply_ssm_decode_matches_reference(name):
    """Three recurrent steps from a non-zero cache."""
    rcfg, rp, tcfg, tp = _params(name, 3)
    rng = np.random.default_rng(4)
    c0 = _cache(rcfg, 2, rng)
    rc, tc = jax.tree.map(jnp.asarray, c0), _torch(c0)
    for _ in range(3):
        u = rng.normal(0, 1, (2, 1, rcfg.d_model)).astype(np.float32)
        want, rc = RSSM.apply_ssm(rp, rcfg, jnp.asarray(u), ssm_cache=rc)
        got, tc = TSSM.apply_ssm(tp, tcfg, torch.from_numpy(u), ssm_cache=tc)
        _close(got, want, 1e-5)
        _close(tc["state"], rc["state"], 1e-5)
        _close(tc["conv"], rc["conv"], 1e-5)


@pytest.mark.parametrize("name", CFGS)
def test_apply_ssm_valid_matches_reference(name):
    """Right-padded rows of unequal valid lengths (one shorter than a
    chunk): the outputs, state and conv window of the reference."""
    rcfg, rp, tcfg, tp = _params(name, 5)
    rng = np.random.default_rng(6)
    s = 2 * rcfg.ssm_chunk
    u = rng.normal(0, 1, (3, s, rcfg.d_model)).astype(np.float32)
    valid = np.arange(s)[None] < np.array([[s], [s - 5], [3]])
    c0 = _cache(rcfg, 3, rng)
    want, rc = RSSM.apply_ssm(rp, rcfg, jnp.asarray(u),
                              ssm_cache=jax.tree.map(jnp.asarray, c0),
                              valid=jnp.asarray(valid))
    got, tc = TSSM.apply_ssm(tp, tcfg, torch.from_numpy(u),
                             ssm_cache=_torch(c0),
                             valid=torch.from_numpy(valid))
    _close(got, want, 1e-5)
    _close(tc["state"], rc["state"], 1e-5)
    _close(tc["conv"], rc["conv"], 1e-5)


def test_init_ssm_cache_matches_reference():
    rcfg, tcfg = _cfgs("hymba-1.5b")
    rcfg, tcfg = (c.replace(compute_dtype="bfloat16") for c in (rcfg, tcfg))
    want = RSSM.init_ssm_cache(rcfg, 3)
    got = TSSM.init_ssm_cache(tcfg, 3, "cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
        assert not got[k].any()


# ---------------------------------------------------------------------------
# The reference's properties (tests/test_models.py:142-172) on the port
# ---------------------------------------------------------------------------
def test_ssd_chunked_vs_recurrent():
    """The chunked scan == the step-by-step recurrence (state-space
    duality), within the reference's 1e-3."""
    _rcfg, _rp, tcfg, tp = _params("models_ssm", 12)
    b, s = 2, 32
    u = torch.from_numpy(np.random.default_rng(13).normal(
        0, 1, (b, s, tcfg.d_model)).astype(np.float32))
    full, _ = TSSM.apply_ssm(tp, tcfg, u)
    cache = TSSM.init_ssm_cache(tcfg, b)
    outs = []
    for t in range(s):
        o, cache = TSSM.apply_ssm(tp, tcfg, u[:, t:t + 1], ssm_cache=cache)
        outs.append(o[:, 0])
    err = float((torch.stack(outs, 1) - full).abs().max())
    assert err < 1e-3, err


def test_ssm_prefill_with_padding_exact():
    """A right-padded prefill with the validity mask leaves the unpadded
    prefill's state (1e-4) and conv window (1e-5)."""
    _rcfg, _rp, tcfg, tp = _params("models_ssm", 14)
    b, s, pad = 1, 16, 8
    u = torch.from_numpy(np.random.default_rng(15).normal(
        0, 1, (b, s, tcfg.d_model)).astype(np.float32))
    up = torch.nn.functional.pad(u, (0, 0, 0, pad))
    valid = torch.tensor([[True] * s + [False] * pad])
    _, c_ref = TSSM.apply_ssm(tp, tcfg, u,
                              ssm_cache=TSSM.init_ssm_cache(tcfg, b))
    _, c_pad = TSSM.apply_ssm(tp, tcfg, up, ssm_cache=TSSM.init_ssm_cache(
        tcfg, b), valid=valid)
    assert float((c_ref["state"] - c_pad["state"]).abs().max()) < 1e-4
    assert float((c_ref["conv"] - c_pad["conv"]).abs().max()) < 1e-5
