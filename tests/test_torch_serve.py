"""The port's decoder and serving engine against the reference package.

The reference's parameters (``repro.models.transformer.init_params``) go
through ``convert.lm_params_from_numpy`` into the port, so both packages
compute the same model; inputs are made with numpy.  At the float32
``.smoke()`` configs of qwen3-4b (qk-norm), granite-3-8b (tied
embeddings) and minitron-8b: ``rmsnorm``, ``apply_rope`` and
``apply_attention`` (prefill, prefill into a cache, decode) within 1e-5,
``forward`` logits within 2e-4 (float32 products summed in another order
through two layers and the unembedding), cached decode against the full
forward (the reference's ``test_decode_matches_forward``), the
sliding-window ring buffer, and ``ServeEngine`` greedy tokens equal to the
reference engine's.  The configs are copies: every field and
``param_count()`` equal.  On the CPU the attention runs the kernel's plain
twin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import config as RCFG
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve.engine import ServeEngine as RServe
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve as TLS
from repro_torch.models import config as TCFG
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ServeEngine as TServe

FAMS = ("qwen3-4b", "granite-3-8b", "minitron-8b")
#: the reference's functions compiled once per shape (eager jax dispatches
#: every op of the layer scan from Python)
R_ATTN = jax.jit(RL.apply_attention, static_argnums=(1,))
R_DECODE = jax.jit(RT.decode_step, static_argnums=(1,))
R_FORWARD = jax.jit(RT.forward, static_argnums=(1,))


def _cfgs(fam: str, **kw):
    return (RC.get_config(fam).smoke().replace(**kw),
            TC.get_config(fam).smoke().replace(**kw))


def _models(fam: str, seed: int = 1, **kw):
    rcfg, tcfg = _cfgs(fam, **kw)
    rp = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), tcfg,
                                      "cpu")
    return rcfg, rp, tcfg, tp


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_configs_equal_reference(arch):
    r, t = RC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    assert r.param_count() == t.param_count() and r.hd == t.hd
    assert dataclasses.asdict(r.smoke()) == dataclasses.asdict(t.smoke())


def test_registry_equals_reference():
    assert TC.list_archs() == RC.list_archs()
    assert TC.SKIPS == RC.SKIPS
    assert list(TC.cells()) == list(RC.cells())
    assert {k: dataclasses.asdict(v) for k, v in TCFG.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RCFG.SHAPES.items()}
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


def test_qwen3_4b_full_width():
    """The configuration served on the card: 4.06e9 parameters, hd = 80."""
    cfg = TC.get_config("qwen3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab) == (36, 2560, 32, 8, 80, 9728, 151936)
    assert cfg.qk_norm and cfg.param_dtype == "bfloat16"
    assert 4.0e9 < cfg.param_count() < 4.1e9


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, 64).astype(np.float32)
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                     1e-5)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("fam", FAMS)
def test_rope_matches_reference(fam):
    cfg = TC.get_config(fam)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        cfg.rope_theta)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("fam", FAMS)
def test_apply_attention_matches_reference(fam):
    """Prefill without a cache, prefill into a cache (block at 0), then two
    decode steps (ring writes): outputs within 1e-5, caches equal."""
    rcfg, rp, tcfg, tp = _models(fam)
    ra = jax.tree.map(lambda a: a[0], rp["blocks"]["attn"])
    ta = tp["blocks"][0]["attn"]
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 9, rcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want, _ = R_ATTN(ra, rcfg, jnp.asarray(x), jnp.asarray(pos))
    got, _ = TL.apply_attention(ta, tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos))
    _close(got, want, 1e-5)
    rc = RL.init_kv_cache(rcfg, 2, 16, jnp.float32)
    tc = TL.init_kv_cache(tcfg, 2, 16, torch.float32)
    steps = [(x, pos)] + [
        (rng.normal(0, 1, (2, 1, rcfg.d_model)).astype(np.float32),
         np.asarray([[9 + i], [3 + i]], np.int32)) for i in range(2)]
    for xs, ps in steps:
        want, rc = R_ATTN(ra, rcfg, jnp.asarray(xs), jnp.asarray(ps),
                          kv_cache=rc)
        got, tc = TL.apply_attention(ta, tcfg, torch.from_numpy(xs),
                                     torch.from_numpy(ps), kv_cache=tc)
        _close(got, want, 1e-5)
        for name in ("k", "v"):
            _close(tc[name], rc[name], 1e-6)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


@pytest.mark.parametrize("fam", FAMS)
def test_forward_matches_reference(fam):
    rcfg, rp, tcfg, tp = _models(fam)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 21))
    want = R_FORWARD(rp, rcfg, {"tokens": jnp.asarray(toks)})
    got = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 21, rcfg.vocab)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("fam", FAMS)
def test_decode_matches_forward(fam):
    """Teacher forcing: step-by-step cached decode reproduces the full
    forward (the reference's test, 2e-3) and the reference's own decode
    logits (2e-4)."""
    rcfg, rp, tcfg, tp = _models(fam, seed=3)
    b, s = 2, 12
    toks = np.random.default_rng(4).integers(0, rcfg.vocab, (b, s))
    full = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    tcache = TT.init_caches(tcfg, b, 32, dtype=torch.float32, device="cpu")
    rcache = RT.init_caches(rcfg, b, 32, dtype=jnp.float32)
    for t in range(s):
        pos = np.full((b, 1), t, np.int32)
        got, tcache = TT.decode_step(tp, tcfg, torch.from_numpy(
            toks[:, t:t + 1]), tcache, torch.from_numpy(pos))
        want, rcache = R_DECODE(rp, rcfg, jnp.asarray(toks[:, t:t + 1]),
                                rcache, jnp.asarray(pos))
        _close(got[:, 0], full[:, t].numpy(), 2e-3)
        _close(got, want, 2e-4)


def test_sliding_window_ring_buffer():
    """Decode past the window: the ring keeps exactly the last W keys."""
    rcfg, rp, tcfg, tp = _models("qwen3-4b", seed=8, sliding_window=8,
                                 n_layers=1)
    b, s = 1, 24
    toks = np.random.default_rng(9).integers(0, rcfg.vocab, (b, s))
    full = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(full, R_FORWARD(rp, rcfg, {"tokens": jnp.asarray(toks)}), 2e-4)
    caches = TT.init_caches(tcfg, b, 64, dtype=torch.float32, device="cpu")
    assert caches[0]["kv"]["k"].shape[1] == 8
    for t in range(s):
        pos = torch.full((b, 1), t, dtype=torch.int32)
        got, caches = TT.decode_step(tp, tcfg, torch.from_numpy(
            toks[:, t:t + 1]), caches, pos)
        _close(got[:, 0], full[:, t].numpy(), 2e-3)


def test_init_params_follow_the_reference_distributions():
    rcfg, tcfg = _cfgs("qwen3-4b", d_model=128, d_ff=256, vocab=512)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    gen = torch.Generator().manual_seed(0)
    tp = TT.init_params(gen, tcfg)
    blk = tp["blocks"][0]
    for name, w in [*blk["attn"].items(), *blk["mlp"].items()]:
        if name.endswith("_norm"):
            assert torch.equal(w["scale"], torch.ones(tcfg.hd))
            continue
        ref = np.asarray(rp["blocks"][name in blk["mlp"] and "mlp" or "attn"]
                         [name][0])
        assert tuple(w.shape) == ref.shape and w.dtype == torch.float32
        assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.05, name
    assert abs(float(tp["embed"]["table"].std()) / 0.02 - 1) < 0.05
    assert torch.equal(tp["final_norm"]["scale"], torch.ones(128))
    assert len(tp["blocks"]) == tcfg.n_layers and "unembed" in tp
    tied = TT.init_params(gen, tcfg.replace(tie_embeddings=True,
                                            param_dtype="bfloat16"))
    assert "unembed" not in tied
    assert tied["embed"]["table"].dtype == torch.bfloat16


def test_bf16_parameters_cross_over_bit_for_bit():
    rcfg, tcfg = _cfgs("granite-3-8b", param_dtype="bfloat16")
    rp = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(2), rcfg))
    tp = convert.lm_params_from_numpy(rp, tcfg, "cpu")
    w = tp["blocks"][1]["mlp"]["w_down"]
    assert w.dtype == torch.bfloat16
    ref = rp["blocks"]["mlp"]["w_down"][1]
    np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                  ref.view(np.int16))
    assert "unembed" not in tp                      # tied embeddings
    with pytest.raises(ValueError, match="blocks"):
        convert.lm_params_from_numpy(rp, tcfg.replace(n_layers=3), "cpu")


# ---------------------------------------------------------------------------
# Serving engine
# ---------------------------------------------------------------------------
def _serve_both(fam, prompts, *, n_slots=2, max_new=5, temperature=0.0):
    rcfg, rp, tcfg, tp = _models(fam)
    re = RServe(rcfg, rp, n_slots=n_slots, max_len=64)
    te = TServe(tcfg, tp, n_slots=n_slots, max_len=64, device="cpu")
    for eng in (re, te):
        for p in prompts:
            eng.submit(p, max_new_tokens=max_new, temperature=temperature)
    return ({r.rid: r.out_tokens for r in re.run()},
            {r.rid: r.out_tokens for r in te.run()}, te)


@pytest.mark.parametrize("fam", FAMS)
def test_engine_greedy_tokens_equal_reference(fam):
    """Three requests on two slots: the third reuses a slot whose cache
    holds the first request's keys."""
    want, got, te = _serve_both(fam, [[3, 4, 5, 6], [9, 8, 7], [2, 11]])
    assert got == want and len(got) == 3
    assert len(te.prefill_s) == 3 and len(te.decode_s) == te._steps


def test_engine_matches_manual_decode():
    """Engine prefill + decode == greedy over a growing full forward."""
    _rcfg, _rp, tcfg, tp = _models("qwen3-4b")
    prompt = [3, 4, 5, 6]
    eng = TServe(tcfg, tp, n_slots=1, max_len=64, device="cpu")
    eng.submit(prompt, max_new_tokens=4)
    got = eng.run()[0].out_tokens
    toks, want = list(prompt), []
    for _ in range(4):
        logits = TT.forward(tp, tcfg, {"tokens": torch.tensor([toks])})
        want.append(int(torch.argmax(logits[0, -1])))
        toks.append(want[-1])
    assert got == want


def test_engine_slot_reuse():
    _rcfg, _rp, tcfg, tp = _models("minitron-8b")
    eng = TServe(tcfg, tp, n_slots=2, max_len=64, device="cpu")
    for i in range(5):
        eng.submit([2 + i, 3 + i], max_new_tokens=3)
    done = eng.run()
    assert sorted(r.rid for r in done) == [1, 2, 3, 4, 5]
    assert all(len(r.out_tokens) == 3 and r.done for r in done)


def test_engine_temperature_sampling_is_deterministic():
    _rcfg, _rp, tcfg, tp = _models("qwen3-4b")
    outs = []
    for seed in (0, 0, 1):
        eng = TServe(tcfg, tp, n_slots=1, max_len=64, seed=seed,
                     device="cpu")
        eng.submit([3, 4], max_new_tokens=16, temperature=1.5)
        outs.append(eng.run()[0].out_tokens)
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]
    assert len(set(outs[0])) > 2              # it actually samples


def test_engine_defaults_to_the_card():
    _rcfg, _rp, tcfg, tp = _models("qwen3-4b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TServe(tcfg, tp)


def test_launch_serve_runs_on_the_cpu(capsys):
    before = FA.launches["flash_attention"]
    done = TLS.main(["--arch", "qwen3-4b", "--smoke", "--requests", "3",
                     "--max-new", "4", "--device", "cpu"])
    assert len(done) == 3 and all(len(r.out_tokens) == 4 for r in done)
    assert FA.launches["flash_attention"] == before   # plain twin on the CPU
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
