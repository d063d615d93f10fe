"""IBM Granite 4.0-H Small in the port, against the plain float32 reference
(``tests/granite_hybrid_reference.py``) at a small size on the CPU, on
seeded random weights: both mixer kinds, each layer a mixer then a MoE,
one SSM group, more experts than the top k, a shared expert, the
published multipliers.

Tolerances: the port and the reference both compute in float32 here (the
small config's types), the same equations with sums in other orders (the
SSD's chunked dual form against a token-by-token recurrence, the experts'
products per expert against per token, the router's softmax over all
experts renormalised against the softmax over the top k), so logits agree
to a few 1e-6 of their size; 1e-4 relative leaves room for the engine's
padded prefill and its cached decode, and a bug of one term in any layer
(a multiplier left out, gate and up swapped) moves them by 1e-2 or more.
"""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import granite_hybrid_reference as R
from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.configs.granite_4_0_h_small import PATTERN
from repro_torch.kernels import moe_grouped as MG
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

ARCH = "granite-4.0-h-small"
#: relative tolerance of float32 logits (see the module's docstring)
TOL = 1e-4
KINDS = {"M": "mamba", "*": "attention"}


def small(**kw):
    """Three Mamba and two attention layers, each with its MoE; one SSM
    group of 4 heads; 8 experts, top 3, one shared; float32."""
    cfg = get_config(ARCH).smoke().replace(
        layer_pattern="M*MM*", n_layers=5, n_experts=8, moe_top_k=3,
        ssm_n_heads=4)
    return cfg.replace(**kw)


def published(c) -> dict:
    """The reference's configuration: the published ``config.json`` keys."""
    return {"layer_types": [KINDS[k] for k in c.layer_pattern],
            "hidden_size": c.d_model, "num_attention_heads": c.n_heads,
            "num_key_value_heads": c.n_kv_heads,
            "mamba_n_heads": c.ssm_heads, "mamba_d_head": c.ssm_head_dim,
            "mamba_n_groups": c.ssm_groups, "mamba_d_state": c.ssm_state,
            "mamba_d_conv": c.ssm_conv,
            "num_experts_per_tok": c.moe_top_k,
            "rms_norm_eps": c.norm_eps,
            "embedding_multiplier": c.embedding_multiplier,
            "residual_multiplier": c.residual_multiplier,
            "logits_scaling": c.logits_scaling,
            "attention_multiplier": c.attn_scale}


def params(cfg, seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return T.init_params(g, cfg)


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_the_published_config_and_its_parameter_count():
    cfg = get_config(ARCH)
    assert cfg.layer_pattern == PATTERN
    assert [i for i, k in enumerate(PATTERN) if k == "*"] == [5, 15, 25, 35]
    assert cfg.layer_kinds.count("ssm") == 36 and cfg.n_attention_layers == 4
    assert cfg.n_moe_layers == 40
    assert (cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups) == (8192, 128, 1)
    assert cfg.param_count() == 32_207_337_984
    # the formula counts what init_params makes, leaf by leaf (the tied
    # unembedding shares the embedding's table)
    s = small()
    p = params(s)
    assert "unembed" not in p
    assert sum(t.numel() for t in _leaves(p)) == s.param_count()
    assert set(p["blocks"][1]) == {"norm", "attn", "norm2", "moe"}
    assert tuple(p["blocks"][0]["moe"]["w_gate_up"].shape) == (8, 64, 64)
    assert tuple(p["blocks"][0]["moe"]["shared"]["w_gate_up"].shape) \
        == (64, 256)


def test_forward_matches_the_reference():
    cfg = small()
    p = params(cfg)
    tok = torch.randint(0, cfg.vocab, (1, 48),
                        generator=torch.Generator().manual_seed(1))
    got = T.forward(p, cfg, {"tokens": tok})[0]
    want = R.forward(p, published(cfg), tok[0])
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("field, value", [
    ("embedding_multiplier", 1.0), ("residual_multiplier", 1.0),
    ("logits_scaling", 1.0), ("attn_scale", 0.0)])
def test_each_multiplier_is_applied(field, value):
    """Each scalar at its neutral value moves the port's logits far from
    the reference's at the published value."""
    cfg = small()
    p = params(cfg, seed=3)
    tok = torch.randint(0, cfg.vocab, (1, 16),
                        generator=torch.Generator().manual_seed(4))
    want = R.forward(p, published(cfg), tok[0])
    got = T.forward(p, cfg.replace(**{field: value}), {"tokens": tok})[0]
    assert rel(got, want) > 1e-2


def test_engine_prefill_then_cached_decode_match_the_full_forward():
    """Prefill (padded to the SSD chunk) then decode through the KV and SSM
    caches, slots reused by a later request, against the reference's full
    forward on prompt plus emitted tokens, position by position."""
    cfg = small()
    p = params(cfg, seed=2)
    eng = ServeEngine(cfg, p, n_slots=2, max_len=64, device="cpu")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in (21, 9, 33)]
    eng.keep_logits = {1, 2, 3}
    for pr in prompts:
        eng.submit(pr, max_new_tokens=5)
    done = eng.run()
    assert sorted(r.rid for r in done) == [1, 2, 3]
    assert eng.prefill_groups == [[2, 1], [3]]
    for r in done:
        seq = r.prompt + r.out_tokens[:-1]
        want = R.forward(p, published(cfg), seq)[len(r.prompt) - 1:]
        got = torch.stack(eng.logits[r.rid])
        assert got.shape == want.shape
        assert rel(got, want) <= TOL, r.rid
        assert r.out_tokens == want.argmax(-1).tolist()
        # the expert choice of every fed position, in every layer
        assert torch.cat(eng.routes[r.rid], 1).shape \
            == (cfg.n_layers, len(seq), cfg.moe_top_k)


def _moe_input(cfg, n=24, seed=4):
    return torch.randn(1, n, cfg.d_model,
                       generator=torch.Generator().manual_seed(seed))


def test_the_softmax_router_feeds_the_dropless_swiglu_experts():
    """The MoE (router, SwiGLU experts on the grouped product, shared
    expert) against the reference; the router's weights are the softmax
    over the top k logits; a capacity that drops pairs changes the
    output."""
    cfg = small()
    p = params(cfg)["blocks"][0]["moe"]
    h = _moe_input(cfg)
    w, idx, _aux = MOE.route(p, cfg, h[0])
    want_w, want_i = R.route(p, published(cfg), h[0])
    assert torch.equal(idx, want_i)
    assert torch.allclose(w, want_w, rtol=1e-6, atol=1e-7)
    got, _aux = MOE.apply_moe(p, cfg, h)
    assert rel(got[0], R.moe(p, published(cfg), h[0])) <= TOL
    capped, _aux = MOE.apply_moe(p, cfg.replace(capacity_factor=0.25), h)
    assert rel(capped[0], got[0]) > 1e-2


def _sorted_rows(counts, d, seed):
    off = torch.tensor([0, *torch.tensor(counts).cumsum(0).tolist()],
                       dtype=torch.int32)
    xs = torch.randn(int(off[-1]), d,
                     generator=torch.Generator().manual_seed(seed))
    return xs, off


def test_the_swiglu_kernel_records_each_launch_in_the_grouped_ring():
    """Its launches write the relu² kernel's ring, one record a launch."""
    e, d, f = 5, 16, 8
    w_gu, w_down = torch.ones(e, 2 * f, d), torch.ones(e, d, f)
    MG.reset_records("cpu")
    for counts in ([3, 0, 0, 2, 1], [0, 0, 4, 0, 0]):
        xs, off = _sorted_rows(counts, d, 13)
        MG.grouped_experts_swiglu(xs, off, w_gu, w_down)
    assert MG.take_records("cpu") == [(3, 6), (1, 4)]
    with pytest.raises(ValueError):
        MG.grouped_experts_swiglu(xs, off, torch.ones(e, 2 * f + 1, d),
                                  w_down)


def _named(prof, prefix):
    out = {}
    for e in prof.events():
        if e.name.startswith(prefix):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def test_spans_and_counters_of_one_run_at_the_published_pattern():
    """The 40 published layers at the smoke widths: 2 requests of 20 and 30
    tokens (one prefill forward of 2 × 32 tokens), 3 new tokens each on 2
    slots (2 decode steps).  Every layer's MoE opens ``moe.route`` /
    ``.dispatch`` / ``.experts`` / ``.combine`` in the forward and in each
    step (40 each a call on the CPU, where the steps run eagerly) and
    writes one launch record of the SwiGLU product a call; each of the 36
    Mamba-2 layers one ``ssm.scan`` a prefill forward and one
    ``ssm.step_plain`` a decode step."""
    cfg = get_config(ARCH).smoke().replace(layer_pattern=PATTERN,
                                           n_layers=40)
    eng = ServeEngine(cfg, params(cfg), n_slots=2, max_len=64, device="cpu")
    for n in (20, 30):
        eng.submit(list(range(1, n + 1)), max_new_tokens=3)
    trace.clear()
    before = dict(MG.launches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run()
    assert MG.launches == before             # the CPU runs the plain twins
    calls = len(eng.prefill_groups) + eng._steps
    assert (len(eng.prefill_groups), eng._steps) == (1, 2)
    assert _named(prof, "serve.") == {"serve.run": 1, "serve.prefill": 1,
                                      "serve.decode": 2}
    assert _named(prof, "moe.") == {f"moe.{k}": 40 * calls for k in
                                    ("route", "dispatch", "experts",
                                     "combine")}
    assert _named(prof, "ssm.") == {"ssm.scan": 36}
    rec, = trace.calls()
    k = cfg.moe_top_k
    assert rec["counts"] == {
        "serve.prompt_tokens": 50, "serve.prefill_forwards": 1,
        "serve.steps": 2, "serve.decode_tokens": 4,
        "moe.launches": 40 * calls, "ssm.scan_plain": 36,
        "ssm.step_plain": 36 * 2,
        "moe.rows": 40 * k * (2 * 32 + 2 * 2),
        "moe.experts": sum(e for e, _r in rec["lists"]["moe.launch"])}
    assert len(rec["lists"]["moe.launch"]) == 40 * calls


@pytest.mark.cuda
def test_the_swiglu_kernel_matches_its_twin_on_card():
    """Granite 4.0-H's expert widths (D 4096, F 768, 72 experts, top 10);
    decode (16 tokens) and prefill (1,024 tokens) tiles; a skewed routing;
    float32 rows.  bf16: the kernel and the twin both sum float32 products
    of the same bf16 values and round twice; a few bf16 ulps of the
    largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    e, d, f, k = 72, 4096, 768, 10
    g = torch.Generator(device="cuda").manual_seed(14)
    w_gu = (torch.randn(e, 2 * f, d, device="cuda", generator=g)
            / math.sqrt(d)).bfloat16()
    w_down = (torch.randn(e, d, f, device="cuda", generator=g)
              / math.sqrt(f)).bfloat16()
    before = MG.launches["moe_grouped_swiglu"]
    for n, skew in ((16, 0.0), (1024, 0.0), (64, 10.0)):
        logits = torch.randn(n, e, device="cuda", generator=g)
        logits[:, :3] += skew
        idx = torch.topk(logits, k, -1).indices.reshape(-1)
        counts = torch.zeros(e + 1, dtype=torch.int32, device="cuda") \
            .scatter_add_(0, idx + 1, torch.ones_like(idx, dtype=torch.int32))
        off = torch.cumsum(counts, 0, dtype=torch.int32)
        xs = torch.randn(n * k, d, device="cuda", generator=g).bfloat16()
        got = MG.grouped_experts_swiglu(xs, off, w_gu, w_down).float()
        want = MG.grouped_experts_swiglu_plain(xs, off, w_gu, w_down).float()
        assert float((got - want).abs().max() / want.abs().max()) <= 2e-2, n
    assert MG.launches["moe_grouped_swiglu"] - before == 3
    xs, off = _sorted_rows([10, 0, 50, 36], 256, 15)
    wgu = torch.randn(4, 256, 256,
                      generator=torch.Generator().manual_seed(16)) / 16
    wd = torch.randn(4, 256, 128,
                     generator=torch.Generator().manual_seed(17)) / 11
    got = MG.grouped_experts_swiglu(xs.cuda(), off.cuda(), wgu.cuda(),
                                    wd.cuda())
    want = MG.grouped_experts_swiglu_plain(xs, off, wgu, wd)
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_the_attention_scale_reaches_the_kernel_on_card():
    """Granite's attention_multiplier in the prefill and decode kernels:
    float32 against the plain version within 1e-5, and far from 1/√hd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator().manual_seed(18)
    for sq, sk in ((256, 256), (1, 300)):
        q = torch.randn(2, sq, 32, 128, generator=g)
        k = torch.randn(2, sk, 8, 128, generator=g)
        v = torch.randn(2, sk, 8, 128, generator=g)
        qp = torch.arange(sk - sq, sk, dtype=torch.int32).repeat(2, 1)
        kp = torch.arange(sk, dtype=torch.int32).repeat(2, 1)
        want, _ = FA.flash_attention_plain(q, k, v, qp, kp, scale=0.0078125)
        got, _ = FA.flash_attention_cuda(q.cuda(), k.cuda(), v.cuda(),
                                         qp.cuda(), kp.cuda(),
                                         scale=0.0078125)
        assert rel(got.cpu(), want) <= 1e-5
        other, _ = FA.flash_attention_plain(q, k, v, qp, kp)
        assert rel(other, want) > 1e-2
