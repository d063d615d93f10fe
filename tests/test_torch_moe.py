"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``).

The reference's parameters (``init_moe``) cross over as numpy; inputs are
made with numpy.  Float32, at the ``.smoke()`` configs of qwen2-moe-a2.7b
(shared experts, top-2 of 4) and grok-1-314b (no shared experts, softcap
irrelevant here) and at ``tests/test_models.py``'s "moe" config: ``out``
within 1e-5 and the aux loss within 1e-6, at a capacity that drops tokens
(``capacity_factor`` 0.5: the test checks that some pairs are dropped) and
at the reference test's 4.0 (none dropped); the float32 gradients of
``sum(out · w) + aux`` within 1e-5 of each leaf's largest entry, through
the dispatch's copies and the combine's gathers.  At bf16 compute the
combine adds each token's contributions in ascending-expert order,
rounding after each add: held to a numpy model of that order.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import moe as RMOE
from repro.models.config import ModelConfig as RModelConfig
from repro_torch import configs as TC
from repro_torch.models import moe as TMOE
from repro_torch.models.config import ModelConfig as TModelConfig

#: tests/test_models.py's "moe" config (without its capacity factor)
_MODELS_MOE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=128, head_dim=16, ssm_chunk=8, moe=True,
                   n_experts=4, n_shared_experts=1, moe_top_k=2, d_expert=32,
                   param_dtype="float32", compute_dtype="float32")
CFGS = ["models_moe", "qwen2-moe-a2.7b", "grok-1-314b"]


def _cfgs(name, **kw):
    if name == "models_moe":
        return (RModelConfig(**_MODELS_MOE).replace(**kw),
                TModelConfig(**_MODELS_MOE).replace(**kw))
    return (RC.get_config(name).smoke().replace(**kw),
            TC.get_config(name).smoke().replace(**kw))


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _dropped(cfg, p, x) -> int:
    """The (token, expert) pairs past their expert's capacity."""
    xt = np.asarray(x, np.float32).reshape(-1, cfg.d_model)
    probs = np.asarray(jax.nn.softmax(xt @ np.asarray(p["router"]), -1))
    top = np.argsort(-probs, -1, kind="stable")[:, :cfg.moe_top_k]
    cap = max(int(cfg.capacity_factor * xt.shape[0] * cfg.moe_top_k
                  / cfg.n_experts), 4)
    counts = np.bincount(top.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("cf", [0.5, 4.0], ids=["drops", "cf4"])
@pytest.mark.parametrize("name", CFGS)
def test_apply_moe_matches_reference(name, cf):
    rcfg, tcfg = _cfgs(name, capacity_factor=cf)
    rp = RMOE.init_moe(jax.random.PRNGKey(1), rcfg)
    x = np.random.default_rng(2).normal(0, 1, (2, 24, rcfg.d_model)).astype(
        np.float32)
    assert (_dropped(rcfg, rp, x) > 0) == (cf < 1)
    want, want_aux = RMOE.apply_moe(rp, rcfg, jnp.asarray(x))
    got, got_aux = TMOE.apply_moe(_torch(jax.tree.map(np.asarray, rp)), tcfg,
                                  torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("name", CFGS)
def test_apply_moe_grads_match_reference(name):
    rcfg, tcfg = _cfgs(name, capacity_factor=0.5)
    rp = RMOE.init_moe(jax.random.PRNGKey(3), rcfg)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 24, rcfg.d_model)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)

    def ref_loss(p, xx):
        out, aux = RMOE.apply_moe(p, rcfg, xx)
        return jnp.sum(out * w) + aux

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    tp = _torch(jax.tree.map(np.asarray, rp))
    leaves = jax.tree.leaves(jax.tree.map(lambda a: a, tp, is_leaf=lambda t:
                                          isinstance(t, torch.Tensor)))
    tx = torch.from_numpy(x).requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    out, aux = TMOE.apply_moe(tp, tcfg, tx)
    loss = (out * torch.from_numpy(w)).sum() + aux
    got = torch.autograd.grad(loss, [tx, *leaves])
    want = [np.asarray(want_x), *map(np.asarray, jax.tree.leaves(want_p))]
    for g, wnt in zip(got, want, strict=True):
        scale = max(float(np.abs(wnt).max()), 1e-30)
        assert float(np.abs(g.numpy() - wnt).max()) <= 1e-5 * scale


def test_init_moe_follows_the_reference():
    rcfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    rp = RMOE.init_moe(jax.random.PRNGKey(0), rcfg)
    tp = TMOE.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.map(lambda a: a.shape, rp) == jax.tree.map(
        lambda t: tuple(t.shape), tp, is_leaf=lambda t: isinstance(
            t, torch.Tensor))
    assert tp["router"].dtype == torch.float32
    for k in ("w_gate", "w_up", "w_down"):
        w = tp[k]
        assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1) < 0.1, k


def test_bf16_combine_adds_in_ascending_expert_order():
    """bf16 compute: each token's output is its K gated expert outputs
    added in ascending-expert order from 0, rounding to bf16 after each
    add, as the reference's sequential scatter-add; a numpy model of that order computes the same
    bits from the port's own expert outputs."""
    _rcfg, tcfg = _cfgs("qwen2-moe-a2.7b", compute_dtype="bfloat16",
                        capacity_factor=4.0, n_shared_experts=0,
                        n_experts=8, moe_top_k=4)
    tp = TMOE.init_moe(torch.Generator().manual_seed(5), tcfg)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (1, 16, tcfg.d_model)).astype(np.float32)).bfloat16()
    got, _aux = TMOE.apply_moe(tp, tcfg, x)
    xt = x.reshape(16, -1)
    probs = torch.softmax(xt.float() @ tp["router"], -1)
    gv, gi = torch.topk(probs, 4, -1)
    gv = gv / gv.sum(-1, keepdim=True)
    bf = ml_dtypes.bfloat16
    want = np.zeros((16, tcfg.d_model), bf)
    for t in range(16):
        for j in torch.argsort(gi[t]).tolist():
            e = int(gi[t, j])
            w = {k: tp[k][e].bfloat16() for k in ("w_gate", "w_up",
                                                   "w_down")}
            h = torch.nn.functional.silu(xt[t:t + 1] @ w["w_gate"]) \
                * (xt[t:t + 1] @ w["w_up"])
            y = (h @ w["w_down"])[0]
            c = (y * gv[t, j].bfloat16()).float().numpy().astype(bf)
            want[t] = (want[t].astype(np.float32) + c.astype(np.float32)
                       ).astype(bf)
    np.testing.assert_array_equal(got.reshape(16, -1).float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_the_swiglu_grouped_twin_is_a_loop_over_the_experts(dtype, tol):
    """Experts with 0 rows in the first, middle and last place: the SwiGLU
    twin (``w_gate_up`` (E, 2F, D), the gate rows first) equals each row
    through its own expert, row by row (float32 sums in another order; in
    bf16 one rounding of either product may land an ulp, 2^-8, apart;
    another expert's row, or gate and up swapped, is off by its whole
    size)."""
    from repro_torch.kernels import moe_grouped as MG
    e, d, f = 6, 32, 24
    g = torch.Generator().manual_seed(11)
    w_gu = (torch.randn(e, 2 * f, d, generator=g) / d ** 0.5).to(dtype)
    w_down = (torch.randn(e, d, f, generator=g) / f ** 0.5).to(dtype)
    counts = [0, 5, 0, 1, 9, 0]
    off = torch.tensor([0, *np.cumsum(counts).tolist()], dtype=torch.int32)
    xs = torch.randn(int(off[-1]), d, generator=g).to(dtype)
    got = MG.grouped_experts_swiglu(xs, off, w_gu, w_down)
    for i in range(xs.shape[0]):
        ex = int((off[1:] <= i).sum())
        gate = w_gu[ex, :f].float() @ xs[i].float()
        up = w_gu[ex, f:].float() @ xs[i].float()
        h = (torch.nn.functional.silu(gate) * up).to(dtype)
        want = (w_down[ex].float() @ h.float()).to(dtype)
        scale = float(want.float().abs().max())
        assert float((got[i].float() - want.float()).abs().max()) \
            <= tol * scale, i


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "models_moe"])
def test_softmax_dropless_equals_the_capacity_path_that_drops_nothing(name):
    """The softmax router on the dropless dispatch (``capacity_factor`` 0:
    SwiGLU experts in the grouped layout, ``w_gate_up`` (E, 2F, D) and the
    shared experts' ``w_gate_up`` (D, 2F)) equals the capacity dispatch at
    a capacity that drops no pair (``E / K``), on the same weights laid out
    for each; float32, sums in another order."""
    _r, cap_cfg = _cfgs(name)
    cap_cfg = cap_cfg.replace(capacity_factor=cap_cfg.n_experts
                              / cap_cfg.moe_top_k)
    drop_cfg = cap_cfg.replace(capacity_factor=0.0)
    p = TMOE.init_moe(torch.Generator().manual_seed(12), cap_cfg)
    assert set(TMOE.init_moe(torch.Generator().manual_seed(12), drop_cfg)) \
        == {"router", "w_gate_up", "w_down"} | ({"shared"} if "shared" in p
                                                 else set())
    q = {"router": p["router"],
         "w_gate_up": torch.cat([p["w_gate"], p["w_up"]], 2)
         .transpose(1, 2).contiguous(),
         "w_down": p["w_down"].transpose(1, 2).contiguous()}
    if "shared" in p:
        q["shared"] = {"w_gate_up": torch.cat([p["shared"]["w_gate"],
                                               p["shared"]["w_up"]], 1),
                       "w_down": p["shared"]["w_down"]}
    x = torch.from_numpy(np.random.default_rng(13).normal(
        0, 1, (2, 12, cap_cfg.d_model)).astype(np.float32))
    assert _dropped(cap_cfg, {"router": p["router"].numpy()}, x) == 0
    want, aux_c = TMOE.apply_moe(p, cap_cfg, x)
    got, aux_d = TMOE.apply_moe(q, drop_cfg, x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float(aux_d) == float(aux_c)
