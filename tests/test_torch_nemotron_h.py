"""NVIDIA Nemotron 3 Nano 30B-A3B in the port, against the plain float32
reference (``tests/nemotron_h_reference.py``) at a small size on the CPU,
on seeded random weights: one layer of each kind at least, two or more SSM
groups, more experts than the top k.

Tolerances: the port and the reference both compute in float32 here (the
small config's types), the same equations with sums in other orders (the
SSD's chunked dual form against a token-by-token recurrence, the experts'
products per expert against per token), so logits agree to a few 1e-6 of
their size; 1e-4 relative leaves room for the engine's padded prefill and
its cached decode, and a bug of one term in any layer moves them by
1e-2 or more.
"""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import nemotron_h_reference as R
from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.kernels import moe_grouped as MG
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

ARCH = "nemotron-3-nano-30b-a3b"
#: relative tolerance of float32 logits (see the module's docstring)
TOL = 1e-4


def small(**kw):
    """Two Mamba, two MoE and one attention layer; 2 SSM groups of 2 heads;
    8 experts, top 2; float32."""
    cfg = get_config(ARCH).smoke().replace(
        layer_pattern="ME*EM", n_layers=5, n_experts=8, moe_top_k=2,
        ssm_n_heads=4, ssm_groups=2)
    return cfg.replace(**kw)


def published(c) -> dict:
    """The reference's configuration: the published ``config.json`` keys."""
    return {"hybrid_override_pattern": c.layer_pattern,
            "num_attention_heads": c.n_heads,
            "num_key_value_heads": c.n_kv_heads, "head_dim": c.hd,
            "mamba_num_heads": c.ssm_heads, "mamba_head_dim": c.ssm_head_dim,
            "n_groups": c.ssm_groups, "ssm_state_size": c.ssm_state,
            "conv_kernel": c.ssm_conv, "num_experts_per_tok": c.moe_top_k,
            "routed_scaling_factor": c.routed_scaling,
            "norm_eps": c.norm_eps}


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
    assert cfg.layer_kinds.count("ssm") == 23
    assert cfg.layer_kinds.count("moe") == 23
    assert cfg.n_attention_layers == 6
    assert (cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups) == (4096, 64, 8)
    assert cfg.param_count() == 31_577_940_288
    # the formula counts what init_params makes, leaf by leaf
    s = small()
    assert sum(t.numel() for t in _leaves(params(s))) == s.param_count()


def test_forward_matches_the_reference():
    cfg = small()
    p = params(cfg)
    tok = torch.randint(0, cfg.vocab, (1, 48),
                        generator=torch.Generator().manual_seed(1))
    got = T.forward(p, cfg, {"tokens": tok})[0]
    want = R.forward(p, published(cfg), tok[0])
    assert rel(got, want) <= TOL


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
    for r in done:
        seq = r.prompt + r.out_tokens[:-1]
        want = R.forward(p, published(cfg), seq)[len(r.prompt) - 1:]
        got = torch.stack(eng.logits[r.rid])
        assert got.shape == want.shape
        assert rel(got, want) <= TOL, r.rid
        assert r.out_tokens == want.argmax(-1).tolist()


#: prompts straddling the SSD chunk's edges (16 in ``small()``), one
#: shorter than ``ssm_conv − 1`` = 3
WAVE = (17, 2, 16, 33, 15, 1, 31)


def _serve_wave(cfg, p, prefill_tokens=None):
    """WAVE on 7 slots of 80 tokens, 5 new tokens each, every request's
    logits and routes kept: -> (engine, requests by id)."""
    eng = ServeEngine(cfg, p, n_slots=7, max_len=80, device="cpu")
    if prefill_tokens is not None:
        eng.prefill_tokens = prefill_tokens
    gen = torch.Generator().manual_seed(8)
    for n in WAVE:
        eng.submit(torch.randint(0, cfg.vocab, (n,), generator=gen).tolist(),
                   max_new_tokens=5)
    eng.keep_logits = set(range(1, len(WAVE) + 1))
    return eng, {r.rid: r for r in eng.run()}


def test_batched_prefill_equals_one_request_a_forward():
    """The wave in batched prefill forwards (rows padded to their group's
    longest, at most ``max_prompt`` = 80 padded tokens a forward) against
    one request a forward and against the reference's full forward: the
    same tokens, logits within TOL, the same expert choices at every fed
    position (each row's routes sliced from its group's)."""
    cfg = small()
    p = params(cfg, seed=7)
    one, want = _serve_wave(cfg, p, prefill_tokens=0)
    eng, got = _serve_wave(cfg, p)
    assert eng.prefill_tokens == eng.max_prompt == 80
    assert len(one.prefill_groups) == len(WAVE)
    assert eng.prefill_groups == [[2, 3, 5, 6], [1, 7], [4]]
    for rid, r in got.items():
        assert r.out_tokens == want[rid].out_tokens, rid
        lg, lo = torch.stack(eng.logits[rid]), torch.stack(one.logits[rid])
        assert rel(lg, lo) <= TOL, rid
        assert torch.equal(torch.cat(eng.routes[rid], 1),
                           torch.cat(one.routes[rid], 1)), rid
        seq = r.prompt + r.out_tokens[:-1]
        ref = R.forward(p, published(cfg), seq)[len(r.prompt) - 1:]
        assert rel(lg, ref) <= TOL, rid
        assert r.out_tokens == ref.argmax(-1).tolist(), rid


def test_prefill_forwards_are_counted_once_a_forward():
    """``serve.prefill_forwards`` counts the forwards (one a group of
    ``prefill_groups``, one ``serve.prefill`` span each), and
    ``ssm.scan_plain`` the chunked mixer calls of each; the prompt tokens
    are those of the requests, batched or not."""
    cfg = small()
    p = params(cfg, seed=7)
    counts = []
    for cap in (None, 0):
        trace.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng, _done = _serve_wave(cfg, p, prefill_tokens=cap)
        rec, = trace.calls()
        n = len(eng.prefill_groups)
        assert rec["counts"]["serve.prefill_forwards"] == n
        assert _named(prof, "serve.prefill") == {"serve.prefill": n}
        # one chunked mixer call a Mamba-2 layer a forward, plain on the CPU
        assert rec["counts"]["ssm.scan_plain"] \
            == cfg.layer_kinds.count("ssm") * n
        assert "ssm.scan_kernel" not in rec["counts"]
        counts.append(rec["counts"])
    assert counts[0]["serve.prompt_tokens"] == sum(WAVE) \
        == counts[1]["serve.prompt_tokens"]
    assert (counts[0]["serve.prefill_forwards"],
            counts[1]["serve.prefill_forwards"]) == (3, len(WAVE))


def test_the_engine_keeps_the_expert_choice_of_every_fed_position():
    """A kept request's routes: per MoE layer, the k experts of each prompt
    position (the prefill) then of each fed token (the decode steps, from
    the graph's route buffers), the same as a full forward's over prompt
    plus emitted tokens (recorded by ``moe.recording``; right-padded to
    the SSD chunk, which the causal positions before it do not see); a
    request not kept leaves none."""
    cfg = small()
    p = params(cfg, seed=5)
    eng = ServeEngine(cfg, p, n_slots=2, max_len=64, device="cpu")
    gen = torch.Generator().manual_seed(6)
    for n in (17, 26):
        eng.submit(torch.randint(0, cfg.vocab, (n,), generator=gen).tolist(),
                   max_new_tokens=4)
    eng.keep_logits = {2}
    done = {r.rid: r for r in eng.run()}
    assert set(eng.routes) == {2}
    got = torch.cat(eng.routes[2], 1)
    r = done[2]
    seq = r.prompt + r.out_tokens[:-1]
    n_moe = cfg.layer_pattern.count("E")
    assert got.shape == (n_moe, len(seq), cfg.moe_top_k)
    pad = -len(seq) % cfg.ssm_chunk          # the SSD takes whole chunks
    with MOE.recording() as routes:
        T.forward(p, cfg, {"tokens": torch.tensor([seq + [0] * pad])})
    assert len(routes) == n_moe
    want = torch.stack(routes)[:, :len(seq)]
    assert torch.equal(got.sort(-1).values, want.sort(-1).values)


def _moe_input(cfg, n=24, seed=4):
    return torch.randn(1, n, cfg.d_model,
                       generator=torch.Generator().manual_seed(seed))


def test_dropless_routing_under_forced_imbalance():
    """Every token routed to expert 0 (its bias raised by 10): the dropless
    layer equals the reference; the capacity path drops pairs here and
    does not."""
    cfg = small()
    p = params(cfg)["blocks"][1]["moe"]
    p = dict(p, router_bias=p["router_bias"].clone())
    p["router_bias"][0] += 10.0
    h = _moe_input(cfg)
    _w, idx = R.route(p, published(cfg), h[0])
    assert bool((idx == 0).any(-1).all())
    want = R.moe(p, published(cfg), h[0])
    got, _aux = MOE.apply_moe(p, cfg, h)
    assert rel(got[0], want) <= TOL
    capped, _aux = MOE.apply_moe(p, cfg.replace(capacity_factor=1.25), h)
    assert rel(capped[0], want) > 1e-2


def test_the_router_bias_changes_the_choice_not_the_weights():
    cfg = small()
    p = params(cfg)["blocks"][1]["moe"]
    xt = _moe_input(cfg, n=64)[0]
    w, idx, _aux = MOE.route(p, cfg, xt)
    plain = {k: v for k, v in p.items() if k != "router_bias"}
    w0, idx0, _aux = MOE.route(dict(plain, router_bias=torch.zeros_like(
        p["router_bias"])), cfg, xt)
    big = dict(p, router_bias=p["router_bias"] * 30)
    wb, idxb, _aux = MOE.route(big, cfg, xt)
    assert not torch.equal(idxb.sort(-1).values, idx0.sort(-1).values)
    scores = torch.sigmoid(xt @ p["router"])
    for ww, ii in ((w, idx), (w0, idx0), (wb, idxb)):
        s = scores.gather(-1, ii)
        # the plain scores at the chosen experts, renormalised, times 2.5
        assert torch.allclose(ww, s / s.sum(-1, keepdim=True) * 2.5,
                              rtol=1e-6)
        assert torch.allclose(ww.sum(-1), torch.full((64,), 2.5), rtol=1e-6)
    want_w, want_i = R.route(p, published(cfg), xt)
    assert torch.equal(idx, want_i) and torch.allclose(w, want_w, rtol=1e-6)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_the_grouped_ssm_mixer_matches_the_reference(groups):
    """The Mamba-2 layer (projection, conv with bias, SSD with head ``h``
    on group ``h // (heads / G)``, the norm over G slices) against the
    token-by-token reference; 40 tokens over 3 chunks of 16."""
    cfg = small(ssm_groups=groups)
    p = SSM.init_ssm(torch.Generator().manual_seed(5), cfg)
    assert p["conv_b"].abs().sum() > 0
    h = _moe_input(cfg, n=40, seed=6)
    got, _c = SSM.apply_ssm(p, cfg, torch.nn.functional.pad(h, (0, 0, 0, 8)))
    want = R.mamba(p, published(cfg), h[0])
    assert rel(got[0, :40], want) <= TOL


def test_each_head_reads_its_own_group():
    """B and C of group 1 changed: heads 0-1 (group 0) keep their outputs
    before the norm's mix, heads 2-3 change — seen through the grouped
    norm, which also keeps the two slices apart."""
    cfg = small()
    p = SSM.init_ssm(torch.Generator().manual_seed(7), cfg)
    u = _moe_input(cfg, n=16, seed=8)
    di, gs = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    proj = u @ p["w_in"]
    bumped = proj.clone()
    n = cfg.ssm_state
    # B of group 1 and C of group 1 (after x: [z | x | B0 B1 | C0 C1 | dt])
    bumped[..., 2 * di + n:2 * di + 2 * n] += 1.0
    bumped[..., 2 * di + gs + n:2 * di + gs + 2 * n] += 1.0
    a = SSM._mixer(p, cfg, proj, None, None)
    b = SSM._mixer(p, cfg, bumped, None, None)
    half = di // 2
    assert torch.equal(a[..., :half], b[..., :half])
    assert not torch.allclose(a[..., half:], b[..., half:])


def test_attention_without_rope_ignores_absolute_positions():
    cfg = small()
    p = L.init_attention(torch.Generator().manual_seed(9), cfg)
    h = _moe_input(cfg, n=12, seed=10)
    pos = torch.arange(12, dtype=torch.int32)[None]
    a, _ = L.apply_attention(p, cfg, h, pos)
    b, _ = L.apply_attention(p, cfg, h, pos + 1000)
    assert torch.allclose(a, b, atol=1e-6)
    want = R.attention(p, published(cfg), h[0])
    assert rel(a[0], want) <= TOL
    roped, _ = L.apply_attention(p, cfg.replace(rope=True), h, pos + 1000)
    assert not torch.allclose(a, roped, atol=1e-3)


def _sorted_rows(counts, d, seed):
    off = torch.tensor([0, *torch.tensor(counts).cumsum(0).tolist()],
                       dtype=torch.int32)
    xs = torch.randn(int(off[-1]), d,
                     generator=torch.Generator().manual_seed(seed))
    return xs, off


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_the_grouped_twin_is_a_loop_over_the_experts(dtype, tol):
    """Experts with 0 rows in the first, middle and last place: the twin
    equals each row through its own expert, row by row (float32 sums in
    another order; in bf16 one rounding of either product may land an ulp,
    2^-8, apart; another expert's row is off by its whole size)."""
    e, d, f = 6, 32, 24
    g = torch.Generator().manual_seed(11)
    w_up = (torch.randn(e, f, d, generator=g) / math.sqrt(d)).to(dtype)
    w_down = (torch.randn(e, d, f, generator=g) / math.sqrt(f)).to(dtype)
    xs, off = _sorted_rows([0, 5, 0, 1, 9, 0], d, 12)
    xs = xs.to(dtype)
    got = MG.grouped_experts(xs, off, w_up, w_down)
    for i in range(xs.shape[0]):
        ex = int((off[1:] <= i).sum())
        h = torch.relu(w_up[ex].float() @ xs[i].float()).square().to(dtype)
        want = (w_down[ex].float() @ h.float()).to(dtype)
        assert rel(got[i].float(), want.float()) <= tol, i
    with pytest.raises(ValueError):
        MG.grouped_experts(xs, off.long(), w_up, w_down)


def test_the_grouped_kernel_records_each_launch():
    e, d, f = 5, 16, 8
    w_up, w_down = torch.ones(e, f, d), torch.ones(e, d, f)
    MG.reset_records("cpu")
    for counts in ([3, 0, 0, 2, 1], [0, 0, 4, 0, 0]):
        xs, off = _sorted_rows(counts, d, 13)
        MG.grouped_experts(xs, off, w_up, w_down)
    assert MG.take_records("cpu") == [(3, 6), (1, 4)]
    assert MG.take_records("cpu") == []


@pytest.mark.cuda
def test_the_grouped_kernel_matches_its_twin_on_card():
    """Nemotron 3 Nano's expert widths; decode (16 tokens) and prefill
    (1,024 tokens) tiles; a skewed routing; float32 rows.  bf16: the kernel and the twin both sum float32 products
    of the same bf16 values and round twice; a few bf16 ulps of the
    largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    e, d, f, k = 128, 2688, 1856, 6
    g = torch.Generator(device="cuda").manual_seed(14)
    w_up = (torch.randn(e, f, d, device="cuda", generator=g)
            / math.sqrt(d)).bfloat16()
    w_down = (torch.randn(e, d, f, device="cuda", generator=g)
              / math.sqrt(f)).bfloat16()
    for n, skew in ((16, 0.0), (1024, 0.0), (64, 10.0)):
        logits = torch.randn(n, e, device="cuda", generator=g)
        logits[:, :3] += skew
        idx = torch.topk(logits, k, -1).indices.reshape(-1)
        counts = torch.zeros(e + 1, dtype=torch.int32, device="cuda") \
            .scatter_add_(0, idx + 1, torch.ones_like(idx, dtype=torch.int32))
        off = torch.cumsum(counts, 0, dtype=torch.int32)
        xs = torch.randn(n * k, d, device="cuda", generator=g).bfloat16()
        got = MG.grouped_experts(xs, off, w_up, w_down).float()
        want = MG.grouped_experts_plain(xs, off, w_up, w_down).float()
        assert float((got - want).abs().max() / want.abs().max()) <= 2e-2
    xs, off = _sorted_rows([10, 0, 50, 36], 256, 15)
    wu = torch.randn(4, 128, 256,
                     generator=torch.Generator().manual_seed(16)) / 16
    wd = torch.randn(4, 256, 128,
                     generator=torch.Generator().manual_seed(17)) / 11
    got = MG.grouped_experts(xs.cuda(), off.cuda(), wu.cuda(), wd.cuda())
    want = MG.grouped_experts_plain(xs, off, wu, wd)
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-5


class _HostReads(TorchDispatchMode):
    """Counts the aten operations that read device data on the host."""

    READS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default, torch.ops.aten.is_nonzero.default,
             torch.ops.aten.equal.default}

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            self.reads.append(func)
        return func(*args, **(kwargs or {}))


def test_the_decode_step_reads_nothing_on_the_host(monkeypatch):
    """Routing, dispatch and combine on device tensors alone: with the
    grouped product (the CPU's twin reads the offsets; the kernels do not)
    replaced by a stand-in, a decode step makes no host read."""
    cfg = small()
    p = params(cfg)
    monkeypatch.setattr(MG, "grouped_experts",
                        lambda xs, off, wu, wd: torch.zeros_like(xs))
    caches = T.init_caches(cfg, 3, 32, dtype=torch.float32, device="cpu")
    tok = torch.tensor([[1], [2], [3]])
    pos = torch.tensor([[0], [4], [9]], dtype=torch.int32)
    with _HostReads() as mode:
        T.decode_step(p, cfg, tok, caches, pos)
    assert mode.reads == []


def _named(prof, prefix):
    out = {}
    for e in prof.events():
        if e.name.startswith(prefix):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def test_spans_and_counters_of_one_run():
    """3 requests of 10, 20 and 30 tokens (pads to 16, 32, 32), 4 new
    tokens each, on 2 slots: 2 prefill forwards (the first two requests in
    one forward of 2 × 32 tokens, the third alone when a slot frees) and 6
    decode steps (3 with two slots busy, then 3 alone); on the CPU every
    decode step runs eagerly, so each MoE layer opens its spans in every
    prefill forward and every step, and each step's grouped product takes
    both slots' rows; each SSM layer of a prefill forward takes the plain
    chunked path on the CPU (``ssm.scan_plain``, no ``ssm.scan_kernel``),
    and of each step the plain recurrent step (``ssm.step_plain``, counted
    by the engine from what the decode graph recorded)."""
    cfg = small()
    eng = ServeEngine(cfg, params(cfg), n_slots=2, max_len=64, device="cpu")
    for n in (10, 20, 30):
        eng.submit(list(range(1, n + 1)), max_new_tokens=4)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run()
    steps, prefills = eng._steps, 2
    assert steps == 6
    assert eng.prefill_groups == [[1, 2], [3]]
    calls = eng_calls = (prefills + steps)
    n_moe, n_ssm = 2, 2
    assert _named(prof, "serve.") == {"serve.run": 1, "serve.prefill": 2,
                                      "serve.decode": steps}
    assert _named(prof, "moe.") == {f"moe.{k}": n_moe * calls for k in
                                    ("route", "dispatch", "experts",
                                     "combine")}
    assert _named(prof, "ssm.") == {"ssm.scan": n_ssm * prefills}
    rec, = trace.calls()
    assert rec["name"] == "serve.run"
    pairs = cfg.moe_top_k
    assert rec["counts"] == {
        "serve.prompt_tokens": 60, "serve.prefill_forwards": prefills,
        "serve.steps": steps,
        "serve.decode_tokens": 9, "moe.launches": n_moe * eng_calls,
        "ssm.scan_plain": n_ssm * prefills, "ssm.step_plain": n_ssm * steps,
        "moe.rows": n_moe * pairs * (2 * 32 + 32 + 2 * steps),
        "moe.experts": sum(e for e, _r in rec["lists"]["moe.launch"])}
    assert len(rec["lists"]["moe.launch"]) == n_moe * eng_calls
    assert all(1 <= e <= cfg.n_experts for e, _r in
               rec["lists"]["moe.launch"])
