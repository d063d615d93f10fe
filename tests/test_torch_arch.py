"""The port's MoE, SSM, hybrid, cross-attention (VLM) and audio decoders
against the reference package.

The reference's parameters (``repro.models.transformer.init_params``) go
through ``convert.lm_params_from_numpy`` into the port (stacked blocks and
cross blocks unstacked), so both packages compute the same model; inputs
are made with numpy.  Float32, at the ``.smoke()`` configs of
qwen2-moe-a2.7b, grok-1-314b, mamba2-780m, hymba-1.5b,
llama-3.2-vision-90b and musicgen-medium and at ``tests/test_models.py``'s
configs (copied here: dense, qk-norm, window, moe, ssm, hybrid, and its
VLM test's config):

* ``forward`` logits within 2e-4 (``input_embeds`` for the audio stub,
  ``image_embeds`` for the VLM);
* cached decode against the port's full forward within 2e-3 (the
  reference's ``test_decode_matches_forward``; MoE at the reference test's
  capacity factor 4.0, since the capacity depends on the token count) and
  against the reference's own decode within 2e-4;
* ``init_caches`` the reference's caches, per self block;
* ``ServeEngine`` greedy tokens equal to the reference engine's for the
  MoE, SSM and hybrid families (SSM / hybrid prompts right-padded to the
  chunk), and the engine's refusal of a VLM (ROADMAP C-9);
* ``extra_mask`` (the unfused path) within 2e-4, and the reference's
  document-mask property;
* ``loss_fn`` and its float32 gradients against ``jax.value_and_grad`` of
  the reference's (loss within 1e-5, each gradient within 1e-5 of its
  largest entry), and one ``build_train_step`` step against the
  reference's jitted step (loss within 1e-5, parameters within 2e-5),
  which also does what ``tests/test_arch_smoke.py`` asks of a step.
On the CPU the attention runs the kernel's plain twin.
"""
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
from repro.train import step as RS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import flash_attention as TFA
from repro_torch.launch import serve as TLS
from repro_torch.models import config as TCFG
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ServeEngine as TServe
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

ARCHS = ("qwen2-moe-a2.7b", "grok-1-314b", "mamba2-780m", "hymba-1.5b",
         "llama-3.2-vision-90b", "musicgen-medium")
#: tests/test_models.py's CONFIGS and its VLM test's config
_BASE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=128, head_dim=16, ssm_chunk=8,
             param_dtype="float32", compute_dtype="float32")
MODELS = {
    "dense": {},
    "qknorm": dict(qk_norm=True),
    "window": dict(sliding_window=8),
    "moe": dict(moe=True, n_experts=4, n_shared_experts=1, moe_top_k=2,
                d_expert=32, capacity_factor=4.0),
    "ssm": dict(n_heads=0, n_kv_heads=0, d_ff=0, block_type="ssm",
                ssm_state=8, ssm_head_dim=16),
    "hybrid": dict(block_type="hybrid", ssm_state=8, ssm_head_dim=16,
                   ssm_expand=1),
    "vlm": dict(cross_attn_every=2, n_image_tokens=4),
}
NAMES = [*ARCHS, *(f"models_{k}" for k in MODELS)]
R_FORWARD = jax.jit(RT.forward, static_argnums=(1,))
R_DECODE = jax.jit(RT.decode_step, static_argnums=(1,))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager tensors: one intra-op thread each, so parallel test
    workers do not oversubscribe the CPU (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name: str, **kw):
    if name.startswith("models_"):
        base = {**_BASE, **MODELS[name[len("models_"):]]}
        return (RCFG.ModelConfig(**base).replace(**kw),
                TCFG.ModelConfig(**base).replace(**kw))
    return (RC.get_config(name).smoke().replace(**kw),
            TC.get_config(name).smoke().replace(**kw))


def _models(name: str, seed: int = 1, **kw):
    rcfg, tcfg = _cfgs(name, **kw)
    rp = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), tcfg,
                                      "cpu")
    return rcfg, rp, tcfg, tp


def _batch(cfg, b: int, s: int, seed: int, labels: bool = False) -> dict:
    """numpy inputs: tokens, and the stub frontends' embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1]}
    if labels:
        out["labels"] = toks[:, 1:]
        out["loss_mask"] = (rng.random((b, s)) < 0.8).astype(np.float32)
    if cfg.cross_attn_every:
        out["image_embeds"] = rng.normal(
            0, 1, (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.audio_frontend_stub:
        out["input_embeds"] = (rng.normal(0, 1, (b, s, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# forward, decode, caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    rcfg, rp, tcfg, tp = _models(name)
    batch = _batch(rcfg, 2, 16, 3)
    want = R_FORWARD(rp, rcfg, jax.tree.map(jnp.asarray, batch))
    got = TT.forward(tp, tcfg, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == (2, 16, rcfg.vocab)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    """Teacher forcing: step-by-step cached decode (a VLM's with the image
    embeddings) reproduces the full forward (2e-3) and the reference's own
    decode logits (2e-4)."""
    kw = {"capacity_factor": 4.0} if _cfgs(name)[0].moe else {}
    rcfg, rp, tcfg, tp = _models(name, seed=3, **kw)
    b, s = 2, 16
    batch = _batch(rcfg, b, s, 4)
    batch.pop("input_embeds", None)            # decode embeds tokens
    img = batch.get("image_embeds")
    full = TT.forward(tp, tcfg, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    tcache = TT.init_caches(tcfg, b, 32, dtype=torch.float32, device="cpu")
    rcache = RT.init_caches(rcfg, b, 32, dtype=jnp.float32)
    toks = batch["tokens"]
    for t in range(s):
        pos = np.full((b, 1), t, np.int32)
        got, tcache = TT.decode_step(
            tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), tcache,
            torch.from_numpy(pos),
            image_embeds=None if img is None else torch.from_numpy(img))
        want, rcache = R_DECODE(rp, rcfg, jnp.asarray(toks[:, t:t + 1]),
                                rcache, jnp.asarray(pos),
                                image_embeds=None if img is None
                                else jnp.asarray(img))
        _close(got[:, 0], full[:, t].numpy(), 2e-3)
        _close(got, want, 2e-4)


@pytest.mark.parametrize("name", NAMES)
def test_init_caches_match_reference(name):
    """One cache per self block: the reference's stacked caches, layer by
    layer (kinds, shapes, types, contents), the conv window in the compute
    type, the KV ring capped at the window."""
    rcfg, tcfg = _cfgs(name, compute_dtype="bfloat16")
    want = RT.init_caches(rcfg, 3, 40, dtype=jnp.float32)
    got = TT.init_caches(tcfg, 3, 40, dtype=torch.float32, device="cpu")
    n_self = tcfg.n_layers - TT.n_cross_blocks(tcfg)
    assert len(got) == n_self
    for i, c in enumerate(got):
        assert set(c) == set(want)
        for kind, part in c.items():
            assert set(part) == set(want[kind])
            for n, t in part.items():
                w = np.asarray(want[kind][n][i])
                assert tuple(t.shape) == w.shape, (kind, n)
                assert str(t.dtype).split(".")[1] == str(want[kind][n].dtype)
                assert np.array_equal(t.float().numpy(), w.astype(np.float32))


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "grok-1-314b",
                                  "mamba2-780m", "hymba-1.5b", "models_ssm",
                                  "models_hybrid"])
def test_engine_greedy_tokens_equal_reference(name):
    """Three requests on two slots (the third reuses a slot: its KV, SSM
    state and conv window are overwritten by the prefill)."""
    rcfg, rp, tcfg, tp = _models(name)
    prompts = [[3, 4, 5, 6, 7, 8, 9, 10, 11], [9, 8, 7], [2, 11, 5, 5]]
    re = RServe(rcfg, rp, n_slots=2, max_len=64)
    te = TServe(tcfg, tp, n_slots=2, max_len=64, device="cpu")
    for eng in (re, te):
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
    want = {r.rid: r.out_tokens for r in re.run()}
    got = {r.rid: r.out_tokens for r in te.run()}
    assert got == want and len(got) == 3


def test_engine_refuses_a_vlm():
    """The reference engine cannot serve a cross-attention config
    (ROADMAP C-9): the port's raises instead of inventing a path."""
    _rcfg, _rp, tcfg, tp = _models("llama-3.2-vision-90b")
    with pytest.raises(NotImplementedError, match="C-9"):
        TServe(tcfg, tp, n_slots=1, max_len=64, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b",
                                  "qwen2-moe-a2.7b"])
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    done = TLS.main(["--arch", arch, "--smoke", "--requests", "3",
                     "--max-new", "4", "--device", "cpu"])
    assert len(done) == 3 and all(len(r.out_tokens) == 4 for r in done)
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# extra_mask: the reference's unfused path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["models_dense", "models_hybrid",
                                  "hymba-1.5b"])
def test_extra_mask_matches_reference(name):
    """A two-document mask: the logits of the reference (2e-4); the first
    document as without the mask, the second changed (the reference's
    ``test_extra_mask_plumbs_through``)."""
    rcfg, rp, tcfg, tp = _models(name, seed=10)
    toks = np.random.default_rng(11).integers(0, rcfg.vocab, (1, 16))
    doc = np.asarray([[0] * 8 + [1] * 8])
    em = doc[:, :, None] == doc[:, None, :]
    want = R_FORWARD(rp, rcfg, {"tokens": jnp.asarray(toks),
                                "extra_mask": jnp.asarray(em)})
    with_mask = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                      "extra_mask": torch.from_numpy(em)})
    _close(with_mask, want, 2e-4)
    without = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert float((with_mask[:, :8] - without[:, :8]).abs().max()) < 2e-4
    assert float((with_mask[:, 8:] - without[:, 8:]).abs().max()) > 1e-3


@pytest.mark.parametrize("sq,sk,window,cap", [(40, 1100, 0, 0.0),
                                              (33, 1100, 300, 5.0),
                                              (8192, 8192, 0, 0.0)])
def test_flash_attend_matches_reference(sq, sk, window, cap):
    """The unfused path alone — the plain twin with ``extra_mask`` on
    unrepeated K/V (a group of 2) against the reference's
    ``_flash_attend`` on the repeated ones: ragged KV chunks (padded
    keys), window, softcap, a random mask with fully masked rows, and a
    prefill past the reference's Q_CHUNK (two Q blocks): within 1e-5."""
    rng = np.random.default_rng(sq + sk)
    b, h, kvh, hd = 1, 4, 2, 8
    q = rng.normal(0, 1, (b, sq, h, hd)).astype(np.float32)
    k, v = (rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32)
            for _ in range(2))
    qp = np.tile(np.arange(sk - sq, sk, dtype=np.int32), (b, 1))
    kp = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    em = rng.random((b, sq, sk)) < 0.7
    em[:, :2] = False
    want = RL._flash_attend(
        *map(jnp.asarray, (q, np.repeat(k, h // kvh, 2),
                           np.repeat(v, h // kvh, 2), qp, kp)),
        extra_mask=jnp.asarray(em), sliding_window=window, softcap=cap)
    got, _lse = TFA.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v, qp, kp)),
        extra_mask=torch.from_numpy(em), window=window, softcap=cap)
    _close(got, want, 1e-5)
    assert not got[:, :2].any()


# ---------------------------------------------------------------------------
# Training: loss_fn's gradients, one train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [*ARCHS, "models_moe", "models_ssm",
                                  "models_hybrid", "models_vlm"])
def test_loss_and_grads_match_reference(name):
    rcfg, rp, tcfg, tp = _models(name, seed=5)
    batch = _batch(rcfg, 2, 16, 6, labels=True)
    fn = jax.jit(jax.value_and_grad(RT.loss_fn, has_aux=True),
                 static_argnums=1)
    (loss, metrics), grads = fn(rp, rcfg, jax.tree.map(jnp.asarray, batch))
    leaves = TO.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    got_loss, got_m = TT.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    # musicgen's token embedding is unused beside input_embeds: zeros
    got = torch.autograd.grad(got_loss, leaves, allow_unused=True,
                              materialize_grads=True)
    assert abs(float(got_loss.detach()) - float(loss)) <= 1e-5
    for k in ("loss", "accuracy", "tokens"):
        assert abs(float(got_m[k]) - float(metrics[k])) <= 1e-5, k
    want = convert.lm_params_from_numpy(jax.tree.map(np.asarray, grads),
                                        tcfg, "cpu")
    for g, w in zip(got, TO.leaves_like(want, tp), strict=True):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step of each family's own optimizer and remat policy (the VLM
    and grok-1: Adafactor with stacked slots, cross blocks included) from
    one state: the reference's loss and parameters; finite metrics, step
    1, parameters changed (``tests/test_arch_smoke.py``)."""
    rcfg, tcfg = _cfgs(arch)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    rtc, ttc = RCFG.TrainConfig(**kw), TCFG.TrainConfig(**kw)
    rs = RS.init_state(jax.random.PRNGKey(1), rcfg, rtc)
    ts = convert.train_state_from_numpy(jax.tree.map(np.asarray, rs), tcfg,
                                        ttc, "cpu")
    before = [t.clone() for t in TO.tree_leaves(ts["params"])]
    batch = _batch(rcfg, 2, 16, 7, labels=True)
    rs, rm = jax.jit(RS.build_train_step(rcfg, rtc))(
        rs, jax.tree.map(jnp.asarray, batch))
    ts, tm = TS.build_train_step(tcfg, ttc)(ts, batch)
    assert bool(torch.isfinite(tm["loss"])) and \
        bool(torch.isfinite(tm["grad_norm"]))
    assert int(ts["step"]) == 1
    assert max(float((a - b).abs().max()) for a, b in zip(
        TO.tree_leaves(ts["params"]), before)) > 0
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-5
    want = convert.lm_params_from_numpy(jax.tree.map(np.asarray,
                                                     rs["params"]), tcfg,
                                        "cpu")
    for g, w in zip(TO.tree_leaves(ts["params"]),
                    TO.leaves_like(want, ts["params"]), strict=True):
        assert float((g - w).abs().max()) <= 2e-5
