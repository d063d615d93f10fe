"""The port's training path against the reference package.

Both packages start from one state: the reference's ``init_params`` /
``init_state`` as numpy, through ``convert.lm_params_from_numpy`` /
``convert.train_state_from_numpy``; inputs are made with numpy.  Held:

* ``TrainConfig`` is a copy (every field equal);
* ``loss_fn`` and its gradients against ``repro.models.transformer.loss_fn``
  / ``jax.value_and_grad`` at the float32 ``.smoke()`` configs of qwen3-4b,
  granite-3-8b and minitron-8b, with the reference's
  ``fused_attention`` off and on, the port's ``remat`` none / block (and
  block_dots: the same gradients), with and without ``loss_mask``: loss
  within 1e-5, each gradient within 1e-5 of its largest entry (float32,
  sums in other orders through two layers);
* ``rmsnorm``'s backward at bf16 (the reference's ``custom_vjp``): ``dx``
  bit for bit, ``dscale`` within 1e-6 relative (float32 sums in another
  order); ``loss_fn``'s gradients at the reference's default bf16 compute
  within bf16 rounding (loss within 1e-3, each gradient within 2^-4 of its
  largest entry: two layers of bf16 products summed in other orders);
* the optimizer and compression functions on the same trees: ``cosine_lr``
  exact, the global norm within 1e-6 relative, AdamW / Adafactor updates
  within 1e-6, ``quantize_int8`` / the error-feedback round bit for bit;
* ``build_train_step`` over 3 steps against the reference's jitted step —
  AdamW and Adafactor, 1 and 4 microbatches, compression none and int8_ef —
  losses within 1e-5, parameters within 2e-5 (the reference's own
  microbatch bound, tests/test_train.py), with float32 compute;
* the loss falls over 25 steps (AdamW, Adafactor), as the reference's
  ``test_loss_decreases_*`` require of it, at its bf16-compute config;
* ``SyntheticLM`` batches (tokens, labels, mask, dedup drops) equal to the
  reference's, both packages in one process;
* the eval step's metrics equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.data import pipeline as RD
from repro.models import config as RCFG
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.train import compress as RCMP
from repro.train import optim as RO
from repro.train import step as RS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.data import pipeline as TD
from repro_torch.models import config as TCFG
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train import compress as TCMP
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

FAMS = ("qwen3-4b", "granite-3-8b", "minitron-8b")
#: the reference's training-test model (tests/test_train.py), float32
#: compute for the parity tests
SHAPE = ("t", 2, 64, 4, 2, 128, 256)
R_CFG = RCFG.ModelConfig(*SHAPE, head_dim=16, compute_dtype="float32")
T_CFG = TCFG.ModelConfig(*SHAPE, head_dim=16, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager tensors: one intra-op thread each, so parallel test
    workers do not oversubscribe the CPU (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, b=2, s=16, seed=0, mask=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _leaves_close(got_tree, want_tree, rel):
    """Every leaf of the port's tree within ``rel`` of the largest entry of
    the reference's matching leaf (matched by key)."""
    got = TO.tree_leaves(got_tree)
    want = TO.leaves_like(want_tree, got_tree)
    for g, w in zip(got, want, strict=True):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) <= rel * scale


# ---------------------------------------------------------------------------
# TrainConfig
# ---------------------------------------------------------------------------
def test_train_config_is_a_copy():
    assert dataclasses.asdict(TCFG.TrainConfig()) == \
        dataclasses.asdict(RCFG.TrainConfig())
    kw = dict(learning_rate=1e-2, n_microbatches=4, grad_compression="int8_ef")
    assert dataclasses.asdict(TCFG.TrainConfig(**kw)) == \
        dataclasses.asdict(RCFG.TrainConfig(**kw))


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------
_REF_GRADS: dict = {}


def _reference_loss_grads(fam, fused, mask):
    """(numpy params, batch, loss, metrics, grads) of the reference, once
    per (family, fused, mask).  Without a mask the reference gets its own
    default, a mask of ones (one compiled function per family and fused);
    the port's batch then has no ``loss_mask`` key."""
    key = (fam, fused, mask)
    if key not in _REF_GRADS:
        cfg = RC.get_config(fam).smoke().replace(fused_attention=fused)
        params = RT.init_params(jax.random.PRNGKey(3), cfg)
        batch = _batch(cfg, mask=mask)
        ref_batch = dict(batch)
        if not mask:
            ref_batch["loss_mask"] = np.ones(batch["labels"].shape,
                                             np.float32)
        fn = jax.jit(jax.value_and_grad(RT.loss_fn, has_aux=True),
                     static_argnums=1)
        (loss, metrics), grads = fn(params, cfg, {
            k: jnp.asarray(v) for k, v in ref_batch.items()})
        _REF_GRADS[key] = (jax.tree.map(np.asarray, params), batch,
                           float(loss), jax.tree.map(float, metrics),
                           jax.tree.map(np.asarray, grads))
    return _REF_GRADS[key]


@pytest.mark.parametrize("mask", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("fam", FAMS)
def test_loss_and_grads_match_reference(fam, fused, remat, mask):
    params, batch, loss, metrics, grads = _reference_loss_grads(fam, fused,
                                                                mask)
    cfg = TC.get_config(fam).smoke().replace(remat=remat)
    tp = convert.lm_params_from_numpy(params, cfg, "cpu")
    leaves = TO.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    got_loss, got_m = TT.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    got = torch.autograd.grad(got_loss, leaves)
    assert abs(float(got_loss.detach()) - loss) <= 1e-5
    for k in ("loss", "accuracy", "tokens"):
        assert abs(float(got_m[k]) - metrics[k]) <= 1e-5, k
    want = convert.lm_params_from_numpy(grads, cfg, "cpu")
    for g, w in zip(got, TO.leaves_like(want, tp), strict=True):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= 1e-5 * scale


def test_remat_policies_give_the_same_gradients():
    """none / block / block_dots: the same function, recomputed or saved;
    the gradients agree to float32 rounding."""
    params, batch, *_ = _reference_loss_grads("qwen3-4b", True, True)
    out = {}
    for remat in ("none", "block", "block_dots"):
        cfg = TC.get_config("qwen3-4b").smoke().replace(remat=remat)
        tp = convert.lm_params_from_numpy(params, cfg, "cpu")
        leaves = TO.tree_leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        loss, _m = TT.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        out[remat] = torch.autograd.grad(loss, leaves)
    for remat in ("block", "block_dots"):
        for g, w in zip(out[remat], out["none"], strict=True):
            assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
    with pytest.raises(ValueError, match="remat"):
        TT.remat_wrap(TC.get_config("qwen3-4b").replace(remat="most"),
                      lambda x: x)


def test_block_remat_recomputes_the_attention_forward():
    """remat="block": one more forward call of the attention per layer in
    the backward (the checkpoint's recompute); "none": none."""
    from repro_torch.kernels import flash_attention as FA
    params, batch, *_ = _reference_loss_grads("qwen3-4b", True, True)
    calls = {}
    plain = FA.flash_attention_plain
    for remat in ("none", "block"):
        cfg = TC.get_config("qwen3-4b").smoke().replace(remat=remat)
        tp = convert.lm_params_from_numpy(params, cfg, "cpu")
        leaves = TO.tree_leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        n = [0]

        def counting(*a, **kw):
            n[0] += 1
            return plain(*a, **kw)

        FA.flash_attention_plain = counting
        try:
            loss, _m = TT.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
            torch.autograd.grad(loss, leaves)
        finally:
            FA.flash_attention_plain = plain
        calls[remat] = n[0]
    assert calls == {"none": 2, "block": 4}


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_rmsnorm_bf16_vjp_matches_reference(scale_dtype):
    """(4, 64, 256) bf16 x: the reference's rounding points give ``dx`` bit
    for bit; ``dscale`` (summed in float32 over every leading axis, cast
    to the scale's type) within 1e-6 relative — a float32 scale; a bf16
    one within one bf16 rounding of that."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 1, (4, 64, 256)), jnp.bfloat16)
    scale = jnp.asarray(rng.normal(1, 0.1, 256), scale_dtype)
    dy = jnp.asarray(rng.normal(0, 1, x.shape), jnp.bfloat16)
    out, vjp = jax.vjp(lambda a, b: RL.rmsnorm({"scale": b}, a), x, scale)
    want_dx, want_ds = vjp(dy)
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a.astype(jnp.float32))).to(getattr(torch, str(a.dtype)))
    tx, ts = t(x).requires_grad_(True), t(scale).requires_grad_(True)
    got = TL.rmsnorm({"scale": ts}, tx)
    assert torch.equal(got.float(), t(out).float())
    dx, ds = torch.autograd.grad(got, [tx, ts], t(dy))
    assert dx.dtype == torch.bfloat16 and ds.dtype == ts.dtype
    assert torch.equal(dx.float(), t(want_dx).float())
    want_ds = t(want_ds).float()
    rel = float((ds.float() - want_ds).abs().max() / want_ds.abs().max())
    assert rel <= (1e-6 if scale_dtype == "float32" else 2.0 ** -8), rel


@pytest.mark.parametrize("fam", ["qwen3-4b", "hymba-1.5b", "mamba2-780m"])
def test_loss_and_grads_at_bf16_compute(fam):
    """The reference's default bf16 compute (float32 parameters): the loss
    within 1e-3 and each gradient within 2^-4 of its largest entry — 16
    bf16 ulps of it, the rounding of two layers of bf16 products and
    cotangents summed in other orders (measured: at most 0.047).  Not MoE:
    there one bf16 rounding can flip a token's top-k choice between two
    near-equal experts (seen at the qwen2-moe smoke config: probabilities
    0.2379 / 0.2407), a discrete change no rounding bound covers."""
    rcfg = RC.get_config(fam).smoke().replace(compute_dtype="bfloat16")
    tcfg = TC.get_config(fam).smoke().replace(compute_dtype="bfloat16")
    params = RT.init_params(jax.random.PRNGKey(3), rcfg)
    batch = _batch(rcfg, mask=False)
    (loss, _m), grads = jax.jit(jax.value_and_grad(RT.loss_fn, has_aux=True),
                                static_argnums=1)(
        params, rcfg, jax.tree.map(jnp.asarray, batch))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      "cpu")
    leaves = TO.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    got_loss, _ = TT.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    got = torch.autograd.grad(got_loss, leaves)
    assert abs(float(got_loss.detach()) - float(loss)) <= 1e-3
    want = convert.lm_params_from_numpy(jax.tree.map(np.asarray, grads),
                                        tcfg, "cpu")
    for g, w in zip(got, TO.leaves_like(want, tp), strict=True):
        assert g.dtype == w.dtype
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= 2.0 ** -4 * scale


# ---------------------------------------------------------------------------
# Optimizers and compression
# ---------------------------------------------------------------------------
def _trees(seed=0):
    """Reference params / grads as numpy (stacked blocks) and the port's."""
    rp = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(seed),
                                                 R_CFG))
    rng = np.random.default_rng(seed)
    rg = jax.tree.map(lambda a: rng.normal(0, 0.1, a.shape).astype(
        np.float32), rp)
    return rp, rg, convert.lm_params_from_numpy(rp, T_CFG, "cpu"), \
        convert.lm_params_from_numpy(rg, T_CFG, "cpu")


def test_cosine_lr_equals_reference():
    for s in (0, 1, 4, 5, 6, 50, 99, 100, 101, 500, 999, 1000, 1200):
        for warm, total in ((5, 25), (100, 1000), (1, 1)):
            want = float(RO.cosine_lr(jnp.int32(s), base_lr=3e-4,
                                      warmup=warm, total=total))
            assert TO.cosine_lr(s, base_lr=3e-4, warmup=warm,
                                total=total) == want


def test_global_norm_and_clip_match_reference():
    rp, rg, tp, tg = _trees(1)
    gl = TO.tree_leaves(tg)
    want_n = float(RO.global_norm(rg))
    assert abs(float(TO.global_norm(gl)) - want_n) <= 1e-6 * want_n
    clipped, gn = RO.clip_by_global_norm(jax.tree.map(jnp.asarray, rg), 0.5)
    got_n = TO.clip_by_global_norm_(gl, 0.5)
    assert abs(float(got_n) - float(gn)) <= 1e-6 * float(gn)
    _leaves_close(tg, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, clipped), T_CFG, "cpu"), 1e-6)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(opt):
    """Two updates from the optimizer's fresh state: parameters and moments
    (Adafactor: the stacked slots) within 1e-6 of the largest entry."""
    rp, rg, tp, tg = _trees(2)
    r_init, r_upd = RO.make_optimizer(opt)
    t_init, t_upd = TO.make_optimizer(opt)
    rs, ts = r_init(jax.tree.map(jnp.asarray, rp)), t_init(tp)
    rparams = jax.tree.map(jnp.asarray, rp)
    kw = dict(weight_decay=0.1)
    if opt == "adamw":
        kw.update(beta1=0.9, beta2=0.95, eps=1e-8)
    r_step = jax.jit(lambda g, s, p, lr: r_upd(g, s, p, lr=lr, **kw))
    for lr in (1e-2, 3e-3):
        rparams, rs = r_step(jax.tree.map(jnp.asarray, rg), rs, rparams,
                             jnp.float32(lr))
        t_upd(TO.tree_leaves(tg), ts, tp, lr=lr, **kw)
    _leaves_close(tp, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rparams), T_CFG, "cpu"), 1e-6)
    want = convert.train_state_from_numpy(
        {"params": rp, "opt": jax.tree.map(np.asarray, rs),
         "step": np.int32(0)}, T_CFG.replace(optimizer=opt),
        TCFG.TrainConfig(), "cpu")["opt"]
    assert int(ts["count"]) == int(want["count"]) == 2
    _leaves_close(ts, want, 1e-6)


def test_adafactor_slots_keep_the_reference_layout():
    """The blocks' slots are stacked over the layers, as the reference's
    (its (L, d) norm scales factor across layers)."""
    rp, _rg, tp, _tg = _trees(3)
    want = jax.tree.map(lambda a: a.shape, RO.adafactor_init(
        jax.tree.map(jnp.asarray, rp))["slots"])
    got = TO.tree_map(lambda t: tuple(t.shape),
                      TO.adafactor_init(tp)["slots"])
    assert got == want


def test_quantize_int8_is_bit_exact():
    rng = np.random.default_rng(4)
    for i in range(50):
        x = (rng.normal(0, 1, (65, 33)) * 10.0 ** rng.uniform(-5, 3)
             ).astype(np.float32)
        if i == 0:
            x[:] = 0                      # the 1e-12 floor of the scale
        e = rng.normal(0, 1e-3, x.shape).astype(np.float32)
        q, s = RCMP.quantize_int8(jnp.asarray(x))
        tq, ts = TCMP.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        assert np.array_equal(tq.numpy(), np.asarray(q))
        assert float(ts) == float(s)
        d, r = RCMP.compress_decompress(jnp.asarray(x), jnp.asarray(e))
        td, tr = TCMP.compress_decompress(torch.from_numpy(x),
                                          torch.from_numpy(e))
        assert np.array_equal(td.numpy(), np.asarray(d))
        assert np.array_equal(tr.numpy(), np.asarray(r))


def test_tree_compression_matches_reference_bit_for_bit():
    """One scale per reference leaf: a block path's layers share it.  The
    reference runs eagerly: under jit XLA may divide by a reciprocal."""
    rp, rg, tp, tg = _trees(5)
    rng = np.random.default_rng(5)
    re = jax.tree.map(lambda a: rng.normal(0, 1e-3, a.shape).astype(
        np.float32), rp)
    te = convert.lm_params_from_numpy(re, T_CFG, "cpu")
    deq, err = RCMP.tree_compress_decompress(
        jax.tree.map(jnp.asarray, rg), jax.tree.map(jnp.asarray, re))
    got = TCMP.tree_compress_decompress_(TO.tree_leaves(tg), te, tp)
    want = convert.lm_params_from_numpy(jax.tree.map(np.asarray, deq), T_CFG,
                                        "cpu")
    for g, w in zip(got, TO.leaves_like(want, tp), strict=True):
        assert torch.equal(g, w)
    want_err = convert.lm_params_from_numpy(jax.tree.map(np.asarray, err),
                                            T_CFG, "cpu")
    for g, w in zip(TO.tree_leaves(te), TO.leaves_like(want_err, te),
                    strict=True):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def _data(batch=8, seq=32, seed=0):
    return RD.SyntheticLM(RD.DataConfig(vocab=256, seq_len=seq,
                                        global_batch=batch, seed=seed))


@pytest.mark.parametrize("comp", ["none", "int8_ef"])
@pytest.mark.parametrize("nmb", [1, 4])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_steps_match_reference(opt, nmb, comp):
    rcfg, tcfg = R_CFG.replace(optimizer=opt), T_CFG.replace(optimizer=opt)
    kw = dict(learning_rate=1e-3, n_microbatches=nmb, grad_compression=comp)
    rtc, ttc = RCFG.TrainConfig(**kw), TCFG.TrainConfig(**kw)
    rs = RS.init_state(jax.random.PRNGKey(0), rcfg, rtc)
    ts = convert.train_state_from_numpy(jax.tree.map(np.asarray, rs), tcfg,
                                        ttc, "cpu")
    r_step = jax.jit(RS.build_train_step(rcfg, rtc))
    t_step = TS.build_train_step(tcfg, ttc)
    data = _data()
    for i in range(3):
        b = data.batch(i)
        rs, rm = r_step(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = t_step(ts, b)
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-5
        assert abs(float(tm["tokens"]) - float(rm["tokens"])) == 0
    assert int(ts["step"]) == 3
    want = convert.lm_params_from_numpy(jax.tree.map(np.asarray,
                                                     rs["params"]), tcfg,
                                        "cpu")
    for g, w in zip(TO.tree_leaves(ts["params"]),
                    TO.leaves_like(want, ts["params"]), strict=True):
        assert float((g - w).abs().max()) <= 2e-5


def test_microbatches_equal_one_batch():
    """The port's own accumulation: 4 microbatches == the whole batch
    (the reference's test_microbatch_equivalence)."""
    out = {}
    rs = jax.tree.map(np.asarray, RS.init_state(
        jax.random.PRNGKey(1), R_CFG, RCFG.TrainConfig()))
    b = _data().batch(0)
    for n in (1, 4):
        tc = TCFG.TrainConfig(learning_rate=1e-3, n_microbatches=n)
        st = convert.train_state_from_numpy(rs, T_CFG, tc, "cpu")
        out[n] = TS.build_train_step(T_CFG, tc)(st, b)
    for g, w in zip(TO.tree_leaves(out[4][0]["params"]),
                    TO.leaves_like(out[1][0]["params"], out[4][0]["params"]),
                    strict=True):
        assert float((g - w).abs().max()) < 2e-5
    assert abs(float(out[4][1]["loss"]) - float(out[1][1]["loss"])) < 1e-4


@pytest.mark.parametrize("opt,lr", [("adamw", 1e-3), ("adafactor", 3e-3)])
def test_loss_decreases(opt, lr):
    """25 steps at the reference test's bf16-compute config."""
    cfg = TCFG.ModelConfig(*SHAPE, head_dim=16, optimizer=opt)
    tc = TCFG.TrainConfig(learning_rate=lr, warmup_steps=5, total_steps=25)
    gen = torch.Generator().manual_seed(0)
    state = TS.init_state(gen, cfg, tc, "cpu")
    step = TS.build_train_step(cfg, tc)
    data = TD.SyntheticLM(TD.DataConfig(vocab=256, seq_len=32,
                                        global_batch=8), device="cpu")
    losses = []
    for i in range(25):
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


def test_eval_step_matches_reference():
    rs = RS.init_state(jax.random.PRNGKey(2), R_CFG, RCFG.TrainConfig())
    b = _data().batch(3)
    want = RS.build_eval_step(R_CFG)(rs["params"], {
        k: jnp.asarray(v) for k, v in b.items()})
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rs["params"]),
                                      T_CFG, "cpu")
    got = TS.build_eval_step(T_CFG)(tp, b)
    for k in ("loss", "accuracy", "tokens"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5, k


def test_init_state_and_step_want_the_generators_device():
    tc = TCFG.TrainConfig(grad_compression="int8_ef")
    st = TS.init_state(torch.Generator().manual_seed(0), T_CFG, tc, "cpu")
    assert set(st) == {"params", "opt", "ef", "step"}
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    # the default device is the card: without one it raises, with one the
    # CPU generator does not fit it
    with pytest.raises((RuntimeError, ValueError)):
        TS.init_state(torch.Generator().manual_seed(0), T_CFG, tc)
    with pytest.raises(ValueError, match="divisible"):
        TS.build_train_step(T_CFG, TCFG.TrainConfig(n_microbatches=3))(
            st, _data().batch(0))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dedup", [False, True])
def test_synthetic_batches_equal_reference(dedup):
    """Same tokens, labels, mask and dedup drops, batch by batch and rank
    by rank (one process: the fingerprints hash alike)."""
    cfg = dict(vocab=300, seq_len=48, global_batch=6, seed=7, dedup=dedup)
    ref = RD.SyntheticLM(RD.DataConfig(**cfg))
    port = TD.SyntheticLM(TD.DataConfig(**cfg), device="cpu")
    assert dataclasses.asdict(TD.DataConfig(**cfg)) == \
        dataclasses.asdict(RD.DataConfig(**cfg))
    for step in range(3):
        for rank, size in ((0, 1), (1, 2), (0, 3)):
            want = ref.batch(step, dp_rank=rank, dp_size=size)
            got = port.batch(step, dp_rank=rank, dp_size=size)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (step, rank, k)
    # the repeated batch 0 is all duplicates under dedup
    assert port.batch(0)["tokens"].shape == (6, 48)
    ref.batch(0)
    assert port.dropped == ref.dropped and (port.dropped > 0) == dedup
    assert port.state_dict() == ref.state_dict()
