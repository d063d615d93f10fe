"""The Mamba-2 mixer's chunked path and recurrent step
(``repro_torch.kernels.ssd``).

On the CPU: the dispatching wrapper runs the plain version, which must equal
the mixer's chunked body as it stood before the kernels came (frozen below as
:func:`_mixer_before`) bit for bit — output, state and conv window — at one
and two groups, bf16 and float32, with right-padded rows, ``"rows"`` into a
larger cache and a prompt shorter than the conv window; the recurrent step,
moved from ``models/ssm.py`` into ``ssd_step_plain``, equals the frozen decode
branch too, over chained steps with a ``valid`` mask.  Where autograd
records, the plain version runs.  Each step counts one ``ssm.step_plain``;
the decode graph records a step's counts and the engine adds them each step.

On the card (``-m cuda``): the kernels against the plain version at the
widths of Nemotron 3 Nano, mamba2-780m, hymba-1.5b and Granite 4.0-H
(one group of 128 heads).  Tolerances, each of
the largest value compared: the conv window is a copy (exact); the final
state is float32 on both sides, its products and its log-decay sums taken in
another order (the exponentials turn an absolute error of the sums, a few
float32 ulps of up to a few hundred, into a relative one): 1e-4; the output
goes through three roundings to the compute type after that float32 sum
(``y + D·x``, the gate, the norm), each of which may land one ulp apart: bf16
2e-2, float32 1e-4.  The step's kernels against the plain step over 64
chained steps: the conv window exact; the state float32 with every product
and sum rounded as the plain step's, so it can part only where the conv's sum
of four products, which the plain step's einsum leaves to a library product,
rounds the other way: :data:`STEP_STATE_TOL`; the output as the chunked
path's (``y``'s sum over N in another order, then the same three roundings).
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.kernels import ssd as SSD
from repro_torch.models import ssm as SSM


def _mixer_before(p, cfg, proj, ssm_cache, valid):
    """``models/ssm.py``'s ``_mixer`` before the kernels (both branches),
    kept to hold the move bit for bit."""
    b, s, _n = proj.shape
    cdt = getattr(torch, cfg.compute_dtype)
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    g = cfg.ssm_groups
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * g * ds, nh], -1)
    conv_w = p["conv_w"].to(cdt)
    conv_b = p["conv_b"].to(cdt)
    kw = cfg.ssm_conv
    rows = None if ssm_cache is None else ssm_cache.get("rows")
    chunked = ssm_cache is None or s > 1 or rows is not None
    if chunked:
        padded = F.pad(xbc, (0, 0, kw - 1, 0))
        conv = sum(padded[:, i:i + s] * conv_w[i] for i in range(kw)) \
            + conv_b
        new_conv = None
        if s >= kw - 1 and kw > 1:
            if valid is not None:
                start = valid.int().sum(1)
                idx = start[:, None] + torch.arange(kw - 1,
                                                    device=proj.device)
                new_conv = padded.gather(1, idx[..., None].expand(
                    -1, -1, padded.shape[-1]))
            else:
                new_conv = padded[:, -(kw - 1):]
    else:
        window = torch.cat([ssm_cache["conv"].to(cdt), xbc], 1)
        conv = (torch.einsum("bkc,kc->bc", window, conv_w) + conv_b)[:, None]
        new_conv = window[:, 1:]
    conv = F.silu(conv)
    x, bm, cm = torch.split(conv, [di, g * ds, g * ds], -1)
    bm, cm = bm.reshape(b, s, g, ds), cm.reshape(b, s, g, ds)
    xh = x.reshape(b, s, nh, hd)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])
    if valid is not None:
        dtv = dtv * valid[:, :, None].float()
    if chunked:
        y, new_state = SSD._ssd_chunked(xh.float(), dtv, p["a_log"],
                                        bm.float(), cm.float(), cfg.ssm_chunk)
    else:
        bh = bm[:, 0].float().repeat_interleave(nh // g, 1)
        ch = cm[:, 0].float().repeat_interleave(nh // g, 1)
        da = torch.exp(dtv[:, 0] * -torch.exp(p["a_log"]))
        upd = bh[..., None] \
            * (dtv[:, 0, :, None] * xh[:, 0].float())[:, :, None, :]
        new_state = ssm_cache["state"] * da[..., None, None] + upd
        y = (ch[:, :, None, :] @ new_state)
        y = y.reshape(b, 1, nh, hd)
    y = y + p["d_skip"][:, None] * xh.float()
    y = y.reshape(b, s, di).to(cdt)
    yz = (y * F.silu(z)).float().reshape(b, s, g, di // g)
    var = yz.square().mean(-1, keepdim=True)
    yn = (yz * torch.rsqrt(var + cfg.norm_eps)).reshape(b, s, di)
    yn = (yn * p["norm"]["scale"].float()).to(cdt)
    if ssm_cache is not None:
        for key, new in (("state", new_state), ("conv", new_conv)):
            if new is None:
                continue
            if rows is None:
                ssm_cache[key].copy_(new)
            else:
                ssm_cache[key].index_copy_(0, rows,
                                           new.to(ssm_cache[key].dtype))
    return yn


def _cfg(groups: int, dtype: str):
    """mamba2-780m's smoke widths (one group) or Nemotron 3 Nano's cut to 4
    heads in 2 groups; chunk 16."""
    if groups == 1:
        cfg = get_config("mamba2-780m").smoke()
    else:
        cfg = get_config("nemotron-3-nano-30b-a3b").smoke().replace(
            ssm_n_heads=4, ssm_groups=2)
    return cfg.replace(ssm_chunk=16, param_dtype=dtype, compute_dtype=dtype)


def _case(cfg, b, s, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    p = SSM.init_ssm(g, cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    u = torch.randn((b, s, cfg.d_model), generator=g, device=device).to(cdt)
    return p, u @ p["w_in"].to(cdt)


def _cache(cfg, n_rows, seed, device="cpu"):
    c = SSM.init_ssm_cache(cfg, n_rows, device)
    g = torch.Generator(device=device).manual_seed(seed)
    for k in ("state", "conv"):
        c[k].copy_(torch.randn(c[k].shape, generator=g, device=device))
    return c


def _two(cfg, n_rows, rows, seed, device="cpu"):
    """Two equal caches (``"rows"`` in both, if given)."""
    out = []
    for _ in range(2):
        c = _cache(cfg, n_rows, seed, device)
        if rows is not None:
            c["rows"] = torch.tensor(rows, device=device)
        out.append(c)
    return out


_CASES = {
    # (batch, seq, valid lengths or None, cache rows or None, cache size)
    "plain": (2, 32, None, None, 0),
    "valid_rows": (3, 48, [48, 30, 5], [4, 0, 2], 5),
    "short_into_rows": (2, 2, None, [1, 3], 4),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
def test_the_wrapper_equals_the_chunked_body_before_it_bit_for_bit(
        groups, dtype, case):
    b, s, lens, rows, n_rows = _CASES[case]
    cfg = _cfg(groups, dtype)
    p, proj = _case(cfg, b, s, seed=groups)
    valid = None if lens is None else \
        torch.arange(s)[None] < torch.tensor(lens)[:, None]
    if n_rows:
        want_c, got_c = _two(cfg, n_rows, rows, seed=3)
        keep = got_c["conv"].clone()
    else:
        want_c = got_c = None
    want = _mixer_before(p, cfg, proj, want_c, valid)
    got = SSD.ssd_mixer(p, cfg, proj, got_c, valid)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if n_rows:
        assert torch.equal(got_c["state"], want_c["state"])
        assert torch.equal(got_c["conv"], want_c["conv"])
        if s < cfg.ssm_conv - 1:     # too short: the old window is kept
            assert torch.equal(got_c["conv"], keep)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
def test_the_decode_step_is_unchanged(groups, dtype):
    cfg = _cfg(groups, dtype)
    p, proj = _case(cfg, 3, 1, seed=5)
    want_c, got_c = _two(cfg, 3, None, seed=6)
    want = _mixer_before(p, cfg, proj, want_c, None)
    got = SSM._mixer(p, cfg, proj, got_c, None)
    assert torch.equal(got, want)
    assert torch.equal(got_c["state"], want_c["state"])
    assert torch.equal(got_c["conv"], want_c["conv"])


def test_autograd_keeps_the_plain_version():
    """Grad mode on and a parameter that needs a gradient: autograd records
    and the call must not go to the kernels (they have no backward); under
    ``no_grad`` or ``inference_mode`` it does not record."""
    cfg = _cfg(2, "float32")
    p, proj = _case(cfg, 2, 32, seed=7)
    assert not SSD._records(p, proj)
    p["conv_w"].requires_grad_(True)
    assert SSD._records(p, proj)
    with torch.no_grad():
        assert not SSD._records(p, proj)
    with torch.inference_mode():
        assert not SSD._records(p, proj)
    out = SSD.ssd_mixer(p, cfg, proj, None, None)
    out.float().square().sum().backward()
    assert p["conv_w"].grad is not None and p["conv_w"].grad.abs().sum() > 0


def test_each_chunked_call_is_counted_once():
    """``ssm.scan_plain`` once a chunked call on the CPU, inside one
    ``ssm.scan`` span; a decode step counts one ``ssm.step_plain`` and
    opens no span."""
    from torch.profiler import ProfilerActivity, profile
    cfg = _cfg(2, "float32")
    p, proj = _case(cfg, 2, 32, seed=8)
    _p, step = _case(cfg, 2, 1, seed=9)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.root("t"):
            SSD.ssd_mixer(p, cfg, proj, None, None)
            SSD.ssd_mixer(p, cfg, proj, None, None)
            SSM._mixer(p, cfg, step, _cache(cfg, 2, 1), None)
    rec, = trace.calls()
    assert rec["counts"] == {"ssm.scan_plain": 2, "ssm.step_plain": 1}
    assert sum(e.name == "ssm.scan" for e in prof.events()) == 2


def _steps(cfg, b, n, seed, device="cpu"):
    """``n`` projections of one token and their ``valid`` masks (B, 1),
    each row a pad at about one step in five (None at B = 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = SSM.init_ssm(g, cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    w_in = p["w_in"].to(cdt)
    out = []
    for _ in range(n):
        u = torch.randn((b, 1, cfg.d_model), generator=g, device=device)
        valid = None if b == 1 else \
            torch.rand((b, 1), generator=g, device=device) > 0.2
        out.append((u.to(cdt) @ w_in, valid))
    return p, out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
def test_the_plain_step_equals_the_decode_branch_before_it(groups, dtype,
                                                           masked):
    """``ssd_step`` (the plain step on the CPU) against the frozen decode
    branch, bit for bit, over 6 chained steps: output, state, window."""
    cfg = _cfg(groups, dtype)
    p, steps = _steps(cfg, 3 if masked else 1, 6, seed=14)
    want_c, got_c = _two(cfg, 3 if masked else 1, None, seed=15)
    for proj, valid in steps:
        want = _mixer_before(p, cfg, proj, want_c, valid)
        got = SSD.ssd_step(p, cfg, proj, got_c, valid)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert torch.equal(got_c["state"], want_c["state"])
        assert torch.equal(got_c["conv"], want_c["conv"])


def test_the_step_refuses_shapes_it_does_not_take():
    """The served widths pass the step's check at any chunk; more than one
    token, ``"rows"``, no cache, a valid mask of another shape or a state
    the kernels do not take raise (nothing falls back)."""
    for arch in ("nemotron-3-nano-30b-a3b", "granite-4.0-h-small",
                 "mamba2-780m", "hymba-1.5b"):
        cfg = get_config(arch).replace(ssm_chunk=64)
        width = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state \
            + cfg.ssm_heads
        proj = torch.zeros((2, 1, width), dtype=torch.bfloat16)
        cache = SSM.init_ssm_cache(cfg, 2)
        SSD._check_step(cfg, proj, cache, torch.ones((2, 1), dtype=bool))
        bad = [(proj.expand(2, 2, width), cache, None),
               (proj, dict(cache, rows=torch.arange(2)), None),
               (proj, None, None),
               (proj, cache, torch.ones((2, 2), dtype=bool)),
               (proj.float(), cache, None)]
        for args in bad:
            with pytest.raises(ValueError):
                SSD._check_step(cfg, *args)
    cfg = get_config("mamba2-780m").replace(ssm_state=64)
    with pytest.raises(ValueError):
        SSD._check_step(cfg, torch.zeros(
            (1, 1, 2 * cfg.d_inner + 2 * 64 + cfg.ssm_heads),
            dtype=torch.bfloat16), SSM.init_ssm_cache(cfg, 1), None)


def test_the_decode_graph_counts_one_step_a_mamba_layer():
    """The decode graph keeps the counts of its warm-up step (one
    ``ssm.step_plain`` a Mamba-2 layer on the CPU) and its eager calls
    count nothing themselves; ``ServeEngine.step`` adds them each step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("mamba2-780m").smoke()
    params = T.init_params(torch.Generator().manual_seed(16), cfg)
    eng = ServeEngine(cfg, params, n_slots=2, max_len=64, device="cpu")
    assert eng.graph.counts == {"ssm.step_plain": cfg.n_layers}
    for n in (5, 9):
        eng.submit(list(range(1, n + 1)), max_new_tokens=3)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.root("alone"):
            eng.graph.run(torch.zeros((2, 1), dtype=torch.int64),
                          torch.zeros((2, 1), dtype=torch.int32))
        eng.run()
    alone, run = trace.calls()
    assert alone["counts"] == {}
    assert eng._steps > 0
    assert run["counts"]["ssm.step_plain"] == cfg.n_layers * eng._steps
    assert "ssm.step_kernel" not in run["counts"]


def test_the_wrapper_refuses_shapes_it_does_not_take():
    """The kernels take head dim 64, state 16 or 128, chunk 128 or 256,
    conv 4; the check raises on others (it does not fall back)."""
    cfg = _cfg(2, "bfloat16")
    p, proj = _case(cfg, 1, 32, seed=10)
    with pytest.raises(ValueError):
        SSD._check(cfg, proj, None, None)
    ok = get_config("nemotron-3-nano-30b-a3b")
    proj = torch.zeros((1, 256, 2 * ok.d_inner + 2 * ok.ssm_groups
                        * ok.ssm_state + ok.ssm_heads), dtype=torch.bfloat16)
    SSD._check(ok, proj, None, None)
    with pytest.raises(ValueError):
        SSD._check(ok.replace(ssm_chunk=64), proj, None, None)
    with pytest.raises(ValueError):
        SSD._check(ok, proj[:, :200], None, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_one_group_width_of_granite(dtype):
    """Granite 4.0-H's mixer: 128 heads in one group, a gated norm over one
    slice of 8,192 (d_model cut to 64: it sets only the projections'
    other side).  The wrapper's check takes it and refuses a group twice as
    wide; the plain version equals the chunked body before the kernels bit
    for bit over two chunks of 256, right-padded rows written into a
    larger cache."""
    base = get_config("granite-4.0-h-small")
    assert (base.ssm_groups, base.d_inner) == (1, SSD.GROUP_WIDTH)
    cfg = base.replace(d_model=64, param_dtype=dtype, compute_dtype=dtype)
    p, proj = _case(cfg, 2, 512, seed=12)
    SSD._check(cfg, proj, None, None)
    wide = cfg.replace(ssm_n_heads=256)
    with pytest.raises(ValueError):
        SSD._check(wide, torch.zeros((1, 256, 2 * wide.d_inner + 2 * 128
                                      + 256)), None, None)
    valid = torch.arange(512)[None] < torch.tensor([512, 300])[:, None]
    want_c, got_c = _two(cfg, 3, [2, 0], seed=13)
    want = _mixer_before(p, cfg, proj, want_c, valid)
    got = SSD.ssd_mixer(p, cfg, proj, got_c, valid)
    assert torch.equal(got, want)
    assert torch.equal(got_c["state"], want_c["state"])
    assert torch.equal(got_c["conv"], want_c["conv"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
ARCHS = ("nemotron-3-nano-30b-a3b", "mamba2-780m", "hymba-1.5b",
         "granite-4.0-h-small")
#: of the largest value compared (see the module's docstring)
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
STATE_TOL = 1e-4


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_the_kernels_match_the_plain_version_on_card(arch):
    """Full widths; B = 1 at 128, 1,024 and 4,096 tokens, then B = 4 rows
    of ragged valid lengths written through ``"rows"`` into a larger
    cache, bf16; one float32 case.  A second launch on the same inputs is
    bit-equal; each call adds the family's launches to the count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(1, s, None, None, 0, "bfloat16") for s in (128, 1024, 4096)]
    cases += [(4, 1024, [1024, 700, 129, 3], [5, 0, 2, 3], 6, "bfloat16"),
              (2, 512, [512, 300], [1, 0], 2, "float32")]
    base = get_config(arch)
    for b, s, lens, rows, n_rows, dtype in cases:
        cfg = base.replace(param_dtype=dtype, compute_dtype=dtype)
        p, proj = _case(cfg, b, s, seed=s + b, device="cuda")
        valid = None if lens is None else (
            torch.arange(s, device="cuda")[None]
            < torch.tensor(lens, device="cuda")[:, None])
        caches = _two(cfg, n_rows, rows, seed=1, device="cuda") \
            if n_rows else [None, None, None]
        if n_rows:
            caches.append(_two(cfg, n_rows, rows, seed=1, device="cuda")[0])
        want = SSD.ssd_mixer_plain(p, cfg, proj, caches[0], valid)
        before = SSD.launches["ssd"]
        got = SSD.ssd_mixer_cuda(p, cfg, proj, caches[1], valid)
        again = SSD.ssd_mixer_cuda(p, cfg, proj, caches[2], valid)
        torch.cuda.synchronize()
        assert SSD.launches["ssd"] - before == 2 * SSD.KERNELS
        tag = (arch, b, s, dtype)
        assert _rel(got, want) <= TOL[dtype], (tag, _rel(got, want))
        assert torch.equal(got, again), tag
        if n_rows:
            assert _rel(caches[1]["state"], caches[0]["state"]) \
                <= STATE_TOL, tag
            assert torch.equal(caches[1]["conv"], caches[0]["conv"]), tag
            assert torch.equal(caches[1]["state"], caches[2]["state"]), tag


@pytest.mark.cuda
def test_the_mixer_launches_the_kernels_on_card_without_autograd():
    """A CUDA call without autograd counts ``ssm.scan_kernel`` and
    launches; with a parameter needing a gradient it counts
    ``ssm.scan_plain`` and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config("nemotron-3-nano-30b-a3b")
    p, proj = _case(cfg, 1, 256, seed=11, device="cuda")
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.root("t"):
            before = SSD.launches["ssd"]
            SSD.ssd_mixer(p, cfg, proj, None, None)
            assert SSD.launches["ssd"] - before == SSD.KERNELS
            p["d_skip"].requires_grad_(True)
            SSD.ssd_mixer(p, cfg, proj, None, None)
            assert SSD.launches["ssd"] - before == SSD.KERNELS
    rec, = trace.calls()
    assert rec["counts"] == {"ssm.scan_kernel": 1, "ssm.scan_plain": 1}


#: the step's state, of the largest state value (see the module's docstring;
#: H100 readings over 64 steps: 0 in bf16 but for Granite's 16 rows, 4.0e-5,
#: and at most 4.2e-7 in float32)
STEP_STATE_TOL = 1e-4


def _kernel_chain(p, cfg, steps, cache, plain=None):
    """Run ``steps`` through ``ssd_step`` on the card inside one traced
    root, the state and window kept in place and no state-sized temporary
    allocated; with ``plain`` (a second cache), the plain step after each
    kernel step, compared.  -> (outputs, the root's counts, launches,
    the largest output and state differences)."""
    ptrs = (cache["state"].data_ptr(), cache["conv"].data_ptr())
    outs, worst, worst_state = [], 0.0, 0.0
    dtype = cfg.compute_dtype
    trace.clear()
    before = SSD.launches["ssd_step"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.root("t"):
            for i, (proj, valid) in enumerate(steps):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                outs.append(SSD.ssd_step(p, cfg, proj, cache, valid))
                torch.cuda.synchronize()
                extra = torch.cuda.max_memory_allocated() - base
                assert extra < cache["state"].nbytes // 4, extra
                if plain is None:
                    continue
                want = SSD.ssd_step_plain(p, cfg, proj, plain, valid)
                err = _rel(outs[-1], want)
                st = _rel(cache["state"], plain["state"])
                assert err <= TOL[dtype], (i, err)
                assert st <= STEP_STATE_TOL, (i, st)
                assert torch.equal(cache["conv"], plain["conv"]), i
                worst, worst_state = max(worst, err), max(worst_state, st)
    assert ptrs == (cache["state"].data_ptr(), cache["conv"].data_ptr())
    rec, = trace.calls()
    return (outs, rec["counts"], SSD.launches["ssd_step"] - before, worst,
            worst_state)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_step_kernels_match_the_plain_step_on_card(arch, b):
    """Full widths, bf16 (and float32 at B = 16), 64 chained steps from a
    random state and window, rows padded at about one step in five (B =
    16): the kernels' output, state and window against the plain step's
    after every step.  A second chain from the same start is equal bit for
    bit; the state and window are written in place (the same storage) and
    no state-sized temporary is allocated; each step counts
    ``ssm.step_kernel`` and three launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("bfloat16", "float32") if b == 16 else ("bfloat16",):
        cfg = get_config(arch).replace(param_dtype=dtype,
                                       compute_dtype=dtype)
        p, steps = _steps(cfg, b, 64, seed=b, device="cuda")
        tag = (arch, b, dtype)
        got_c, plain_c, again_c = (_cache(cfg, b, 17, "cuda")
                                   for _ in range(3))
        outs, counts, n, worst, worst_state = _kernel_chain(
            p, cfg, steps, got_c, plain_c)
        print(f"{tag}: output {worst}, state {worst_state} of the largest")
        assert counts == {"ssm.step_kernel": len(steps)}, tag
        assert n == SSD.STEP_KERNELS * len(steps), tag
        again = _kernel_chain(p, cfg, steps, again_c)[0]
        assert all(torch.equal(x, y) for x, y in
                   zip(outs, again, strict=True)), tag
        assert torch.equal(got_c["state"], again_c["state"]), tag
        assert torch.equal(got_c["conv"], again_c["conv"]), tag
