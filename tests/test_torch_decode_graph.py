"""The port's decode step as one captured graph (``serve/graph.py``,
``DecodeGraph``) against the reference's jitted engine.

At the float32 ``.smoke()`` configs of every family the engine serves —
dense (qwen3-4b), MoE (qwen2-moe-a2.7b), hybrid (hymba-1.5b, its 16-slot
KV ring wrapped), SSM (mamba2-780m), the audio decoder (musicgen-medium)
— and the VLM's ``decode_step`` with image embeddings:

* ``decode_step`` calls none of the ops that make the host wait for the
  device (``aten._local_scalar_dense`` — ``.item()``, ``int(t)`` —,
  ``aten.nonzero``, ``aten.is_nonzero`` — ``bool(t)`` —, ``aten.equal``):
  any of them breaks a CUDA graph capture;
* the graph's warm-up plus restore leaves every cache bit-equal to
  ``init_caches``, and a step then writes them (so the restore is what
  kept them);
* ``ServeEngine`` on the graph gives the reference engine's greedy tokens
  (the reference's ``decode_step`` jitted, as its engine does), with a
  prompt shorter than ``ssm_conv − 1``;
* a temperature slot gives the tokens of a step-by-step eager run;
* ``DecodeGraph.run`` with the VLM's static image embeddings gives
  ``decode_step``'s logits bit for bit.

On the CPU the graph object runs its call eagerly on its static buffers
(no capture); the capture and the replay run on the card only
(``test_decode_graph_replays_on_card``, marked ``cuda``).  The reference
(and jax) is imported inside the one test that runs it, so that the card
test runs where jax is not installed.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd as SSD
from repro_torch.launch import serve as TLS
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import Request, _prefill_fn
from repro_torch.serve.engine import ServeEngine as TServe
from repro_torch.serve.graph import DecodeGraph

#: the families the engine serves
SERVED = ("qwen3-4b", "qwen2-moe-a2.7b", "hymba-1.5b", "mamba2-780m",
          "musicgen-medium")
VLM = "llama-3.2-vision-90b"
#: the ops that read a device value on the host
SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "is_nonzero",
                      "equal"})
SLOTS = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager tensors: one intra-op thread each, so parallel test
    workers do not oversubscribe the CPU (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name: str, seed: int = 0, device="cpu"):
    """The port's smoke config and random parameters on ``device``."""
    cfg = TC.get_config(name).smoke()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return cfg, TT.init_params(gen, cfg)


def _image(cfg, b: int, seed: int = 0, device="cpu"):
    if not cfg.cross_attn_every:
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(
        0, 1, (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    ).to(device)


def _decode_inputs(cfg, seed: int = 0):
    """(B, 1) tokens and positions; positions past the ring for a window
    (hymba's 16 slots wrap)."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (SLOTS, 1)))
    top = 3 * (cfg.sliding_window or 16)
    pos = torch.from_numpy(rng.integers(cfg.sliding_window or 1, top,
                                        (SLOTS, 1)).astype(np.int32))
    return toks, pos


class _Ops(TorchDispatchMode):
    """Records the name of every aten op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names: set[str] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# Capturable: no host sync in any family's decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [*SERVED, VLM])
def test_decode_step_makes_no_host_sync(name):
    cfg, params = _port(name)
    caches = TT.init_caches(cfg, SLOTS, 64, dtype=torch.float32,
                            device="cpu")
    toks, pos = _decode_inputs(cfg)
    img = _image(cfg, SLOTS)
    with _Ops() as ops, torch.no_grad():
        for _ in range(2):        # the second step reads what the first wrote
            logits, caches = TT.decode_step(params, cfg, toks, caches, pos,
                                            image_embeds=img)
            greedy = torch.argmax(logits[:, 0], -1)
            pos = pos + 1
    assert logits.shape == (SLOTS, 1, cfg.vocab) and greedy.shape == (SLOTS,)
    assert not ops.names & SYNC_OPS, sorted(ops.names & SYNC_OPS)
    # the mode does see the ops (the check is not vacuous)
    assert {"mm", "argmax"} <= ops.names, sorted(ops.names)


# ---------------------------------------------------------------------------
# The warm-up is undone
# ---------------------------------------------------------------------------
def _flat(caches):
    return [t for c in caches for part in c.values() for t in part.values()]


@pytest.mark.parametrize("name", [*SERVED, VLM])
def test_warm_up_and_restore_leave_the_caches_at_init(name):
    cfg, params = _port(name)
    caches = TT.init_caches(cfg, SLOTS, 64, dtype=torch.float32,
                            device="cpu")
    graph = DecodeGraph(params, cfg, caches, SLOTS, device="cpu",
                        image_embeds=_image(cfg, SLOTS))
    fresh = TT.init_caches(cfg, SLOTS, 64, dtype=torch.float32, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_flat(caches),
                                                  _flat(fresh), strict=True))
    # a step writes every cache tensor (K/V, positions, SSM state, conv
    # window): the warm-up did too, and only the restore undid it
    toks, pos = _decode_inputs(cfg, seed=1)
    graph.run(toks, pos)
    assert not any(torch.equal(a, b) for a, b in zip(_flat(caches),
                                                     _flat(fresh),
                                                     strict=True))


def test_static_inputs_are_fixed_and_aligned():
    cfg, params = _port("qwen3-4b")
    caches = TT.init_caches(cfg, SLOTS, 64, dtype=torch.float32,
                            device="cpu")
    graph = DecodeGraph(params, cfg, caches, SLOTS, device="cpu")
    ptrs = (graph.tokens.data_ptr(), graph.positions.data_ptr())
    assert graph.tokens.dtype == torch.int64 and \
        graph.positions.dtype == torch.int32
    assert graph.positions.data_ptr() % 16 == 0
    toks, pos = _decode_inputs(cfg)
    # numpy-born int32 tokens and a sliced (unaligned) position column
    row = torch.arange(40, dtype=torch.int32)[None].repeat(SLOTS, 1)
    logits, greedy = graph.run(toks.int(), row[:, 7:8])
    assert (graph.tokens.data_ptr(), graph.positions.data_ptr()) == ptrs
    assert torch.equal(graph.positions, row[:, 7:8])
    assert torch.equal(greedy, torch.argmax(logits[:, 0], -1))


# ---------------------------------------------------------------------------
# The engine on the graph against the reference's jitted engine
# ---------------------------------------------------------------------------
def _models(name: str, seed: int = 1):
    import jax

    from repro import configs as RC
    from repro.models import transformer as RT
    rcfg = RC.get_config(name).smoke()
    tcfg = TC.get_config(name).smoke()
    rp = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), tcfg,
                                      "cpu")
    return rcfg, rp, tcfg, tp


#: five requests on two slots (the later ones reuse slots); the second is
#: shorter than ``ssm_conv − 1`` = 3; 12 + 8 positions wrap hymba's ring
PROMPTS = ([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14], [7, 3],
           [9, 8, 7, 6, 5], [2, 11, 5, 5], [4])


@pytest.mark.parametrize("name", SERVED)
def test_engine_greedy_tokens_equal_reference(name):
    from repro.serve.engine import ServeEngine as RServe
    rcfg, rp, tcfg, tp = _models(name)
    re = RServe(rcfg, rp, n_slots=2, max_len=64)
    te = TServe(tcfg, tp, n_slots=2, max_len=64, device="cpu")
    assert te.graph.graph is None           # the CPU runs the call eagerly
    for eng in (re, te):
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=8)
    want = {r.rid: r.out_tokens for r in re.run()}
    got = {r.rid: r.out_tokens for r in te.run()}
    assert got == want and len(got) == len(PROMPTS)
    assert len(te.decode_s) == te._steps


def _eager_run(eng: TServe, prompts, temps, max_new: int):
    """The engine's requests served step by step without the graph:
    ``_prefill_fn`` into fresh caches, ``decode_step`` every step, each slot
    sampled by the engine's formula (``ServeEngine._sample``)."""
    cfg, params = eng.cfg, eng.params
    caches = TT.init_caches(cfg, len(prompts), eng.max_len,
                            dtype=torch.float32, device="cpu")
    reqs = [Request(i + 1, list(p), max_new, t)
            for i, (p, t) in enumerate(zip(prompts, temps, strict=True))]
    for slot, req in enumerate(reqs):
        s = len(req.prompt)
        s_pad = -(-s // eng.chunk) * eng.chunk
        tok = torch.zeros((1, s_pad), dtype=torch.int64)
        tok[0, :s] = torch.tensor(req.prompt)
        valid = (torch.arange(s_pad) < s)[None]
        views = [{k: {n: t[slot:slot + 1] for n, t in part.items()}
                  for k, part in c.items()} for c in caches]
        logits, _ = _prefill_fn(params, cfg, tok, valid, views)
        req.out_tokens.append(eng._sample(logits[0], req))
    while len(reqs[0].out_tokens) < max_new:
        toks = torch.tensor([[r.out_tokens[-1]] for r in reqs])
        pos = torch.tensor([[len(r.prompt) + len(r.out_tokens) - 1]
                            for r in reqs], dtype=torch.int32)
        logits, caches = TT.decode_step(params, cfg, toks, caches, pos)
        for slot, req in enumerate(reqs):
            req.out_tokens.append(eng._sample(logits[slot, 0], req))
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("name", ["qwen3-4b", "mamba2-780m", "hymba-1.5b"])
def test_temperature_slot_equals_a_step_by_step_eager_run(name):
    cfg, params = _port(name, seed=2)
    prompts, temps = ([5, 6, 7, 8, 9], [3, 4]), (1.0, 0.0)
    eng = TServe(cfg, params, n_slots=2, max_len=64, seed=3, device="cpu")
    for p, t in zip(prompts, temps, strict=True):
        eng.submit(p, max_new_tokens=12, temperature=t)
    got = [r.out_tokens for r in sorted(eng.run(), key=lambda r: r.rid)]
    want = _eager_run(eng, prompts, temps, 12)
    assert got == want
    assert len(set(got[0])) > 2                 # it actually samples


def test_vlm_graph_with_image_embeds_equals_decode_step():
    """The VLM's teacher-forced steps through ``DecodeGraph.run`` (static
    image embeddings; positions sliced from one row) against
    ``decode_step`` on a copy of the caches: the same logits bit for bit."""
    cfg, params = _port(VLM)
    img = _image(cfg, 1)
    caches = TT.init_caches(cfg, 1, 64, dtype=torch.float32, device="cpu")
    graph = DecodeGraph(params, cfg, caches, 1, device="cpu",
                        image_embeds=img)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        2, cfg.vocab, (1, 24)))
    pos = torch.arange(24, dtype=torch.int32)[None]
    TT.decode_step(params, cfg, toks[:, :16], caches, pos[:, :16],
                   image_embeds=img)
    eager = [{k: {n: t.clone() for n, t in part.items()}
              for k, part in c.items()} for c in caches]
    for t in range(16, 24):
        got, _ = graph.run(toks[:, t:t + 1], pos[:, t:t + 1])
        want, eager = TT.decode_step(params, cfg, toks[:, t:t + 1], eager,
                                     pos[:, t:t + 1], image_embeds=img)
        assert torch.equal(got, want), t


def test_launch_serve_prints_decode_ms(capsys):
    TLS.main(["--arch", "mamba2-780m", "--smoke", "--requests", "3",
              "--max-new", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ms per step (median of 3)" in out, out


# ---------------------------------------------------------------------------
# On the card: capture, replay, launch counts
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph and the attention "
                    "kernel have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-4b", "hymba-1.5b", "mamba2-780m"])
def test_decode_graph_replays_on_card(name, card):
    """Eight replays against eight eager ``decode_step`` calls on a copy of
    the caches: the same greedy tokens and logits; a replay counts one
    attention launch and one merge per attention layer (the split path
    at 4 one-query rows).  The SSM families' mixers take the widths the
    step kernels take (head dim 64, state 16; the smoke config's 16 and 8
    are refused on the card): a replay counts the step's three launches
    and one ``ssm.step_kernel`` per Mamba-2 layer."""
    cfg, params = _port(name, device=card)
    if cfg.has_ssm:
        cfg = cfg.replace(ssm_head_dim=64, ssm_state=16)
        params = TT.init_params(torch.Generator(device=card).manual_seed(0),
                                cfg)
    caches = TT.init_caches(cfg, SLOTS, 64, dtype=torch.float32, device=card)
    graph = DecodeGraph(params, cfg, caches, SLOTS, device=card)
    assert graph.graph is not None
    attn = 0 if cfg.block_type == "ssm" else cfg.n_layers
    split = attn and FA.split_plan(SLOTS, 1, cfg.n_heads, cfg.n_kv_heads,
                                   caches[0]["kv"]["k"].shape[1],
                                   FA.sm_count(card))[0] > 1
    assert graph.per_replay == {"flash_attention": attn,
                                "flash_attention_combine": attn * split,
                                "flash_attention_bwd": 0}
    n_ssm = sum(k in ("ssm", "hybrid") for k in cfg.layer_kinds)
    assert graph.ssd_per_replay == {"ssd": 0,
                                    "ssd_step": SSD.STEP_KERNELS * n_ssm}
    assert graph.counts == ({"ssm.step_kernel": n_ssm} if n_ssm else {})
    eager = [{k: {n: t.clone() for n, t in part.items()}
              for k, part in c.items()} for c in caches]
    toks, pos = _decode_inputs(cfg)
    toks, pos = toks.to(card), pos.to(card)
    before = dict(FA.launches)
    for _ in range(8):
        logits, greedy = graph.run(toks, pos)
        with torch.no_grad():
            want, eager = TT.decode_step(params, cfg, toks, eager, pos)
        assert torch.equal(greedy, torch.argmax(want[:, 0], -1))
        assert float((logits - want).abs().max()) <= 1e-5
        toks, pos = greedy[:, None].clone(), pos + 1
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] - before["flash_attention"] == \
        16 * attn
