"""Port PuD engine slice (CPU) against the reference package.

The compiler's front half emits the reference's instruction lists; the
port's ``PudEngine`` on ``torch`` / ``kernel`` equals the reference on
``jnp`` / ``pallas`` (results and ``OffloadReport.summary()`` field for
field); its ``dram`` backend under ``draws="numpy"`` equals the reference's
``dram`` backend bit for bit, noisy and with two banks; the mask, Bloom and
dot-product workloads equal the reference's.  Inputs are made with numpy
and handed to both packages; packed planes cross over as int32 views of the
reference's uint32 words.  Also: no module of the port imports jax or
``repro``.
"""
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import compiler as RCC
from repro.kernels import ops as rkops
from repro.pud import masks as RM
from repro.pud import workloads as RW
from repro.pud.bloom import PudBloomFilter as RBloom
from repro.pud.engine import PudEngine as REngine
from repro_torch.core import compiler as TCC
from repro_torch.core.policy import EngineConfig
from repro_torch.kernels import ops as tkops
from repro_torch.pud import masks as TM
from repro_torch.pud import workloads as TW
from repro_torch.pud.bloom import PudBloomFilter as TBloom
from repro_torch.pud.engine import PudEngine as TEngine

SRC = Path(__file__).resolve().parents[1] / "src"
RNG = np.random.default_rng(0)
CPU = dict(device="cpu")
#: port backend -> the reference backend it mirrors
TWIN = {"torch": "jnp", "kernel": "pallas"}


def _planes(*shape) -> np.ndarray:
    return RNG.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _u32(x) -> np.ndarray:
    """A port plane (int32 tensor) or a reference plane as uint32 words."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().view(np.uint32)
    return np.asarray(x)


def _same(port, ref) -> bool:
    return np.array_equal(_u32(port), _u32(ref))


# ---------------------------------------------------------------------------
# Compiler front half
# ---------------------------------------------------------------------------
def _exprs(CC, case):
    a, b, c = CC.Var("a"), CC.Var("b"), CC.Var("c")
    return {
        "xor": lambda: CC.Xor(a, b),
        "maj": lambda: CC.Maj(a, b, c),
        "nor20": lambda: CC.Nor([CC.Var(f"x{i}") for i in range(20)]),
        "mixed": lambda: {"x": CC.Xor(a, b), "n": ~(a & b | c),
                          "k": CC.Const(True) & a},
        "adder4": lambda: CC.adder_exprs(4),
        "dot8": lambda: CC.dot_exprs(8),
        "popcount5": lambda: CC.popcount_exprs(5),
        "bloom_insert": lambda: CC.bloom_insert_exprs(4),
        "bloom_probe": lambda: CC.bloom_probe_exprs(4),
    }[case]()


def _instrs(prog):
    return [(i.op, i.dst, i.srcs, i.name, i.value) for i in prog.instrs]


@pytest.mark.parametrize("case", ["xor", "maj", "nor20", "mixed", "adder4",
                                  "dot8", "popcount5", "bloom_insert",
                                  "bloom_probe"])
def test_compile_expr_matches_reference(case):
    got = TCC.compile_expr(_exprs(TCC, case))
    want = RCC.compile_expr(_exprs(RCC, case))
    assert _instrs(got) == _instrs(want)
    assert got.outputs == want.outputs and got.n_regs == want.n_regs
    assert got.stats() == want.stats()
    assert dataclasses.astuple(got.cost()) == \
        dataclasses.astuple(want.cost())
    names = sorted({i.name for i in got.instrs if i.op == "input"})
    ins = {n: RNG.integers(0, 2, (3, 40), dtype=np.uint8) for n in names}
    g, w = TCC.run_ideal(got, ins, 40), RCC.run_ideal(want, ins, 40)
    assert g.keys() == w.keys()
    assert all(np.array_equal(g[k], w[k]) for k in g)


def test_add_bitplanes_ideal_and_probe_guard():
    a = RNG.integers(0, 2, (5, 33), dtype=np.uint8)
    b = RNG.integers(0, 2, (5, 33), dtype=np.uint8)
    assert np.array_equal(TCC.add_bitplanes_ideal(a, b),
                          RCC.add_bitplanes_ideal(a, b))
    with pytest.raises(ValueError):
        TCC.bloom_probe_exprs(1)


# ---------------------------------------------------------------------------
# Engine: torch / kernel vs jnp / pallas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_backends_agree(backend):
    eng, ref_eng = TEngine(backend, **CPU), REngine(TWIN[backend])
    p = _planes(4, 4, 64)
    for op in ("and", "or", "nand", "nor", "xor"):
        assert _same(eng.nary(p, op), ref_eng.nary(p, op)), op
    assert _same(eng.not_(p[0]), ref_eng.not_(p[0]))
    a, b = _planes(5, 2, 8), _planes(5, 2, 8)
    assert _same(eng.add(a, b), ref_eng.add(a, b))
    assert _same(eng.popcount(p), ref_eng.popcount(p))
    assert eng.report.summary() == ref_eng.report.summary()


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_run_program_agrees_with_ideal(backend):
    prog_t = TCC.compile_expr(_exprs(TCC, "mixed")
                              | {"m": TCC.Maj(*(TCC.Var(v) for v in "abc"))})
    prog_r = RCC.compile_expr(_exprs(RCC, "mixed")
                              | {"m": RCC.Maj(*(RCC.Var(v) for v in "abc"))})
    a, b, c = _planes(3, 2, 8)
    eng, ref_eng = TEngine(backend, **CPU), REngine(TWIN[backend])
    out = eng.run_program(prog_t, {"a": a, "b": b, "c": c})
    want = ref_eng.run_program(prog_r, {"a": a, "b": b, "c": c})
    assert out.keys() == want.keys()
    for k in out:
        assert _same(out[k], want[k]), k
    assert _same(out["x"], a ^ b)
    assert _same(out["m"], (a & b) | (c & (a | b)))
    assert eng.report.ops == len([i for i in prog_t.instrs
                                  if i.op not in ("input", "const")])
    assert eng.report.summary() == ref_eng.report.summary()


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_run_program_input_validation(backend):
    prog = TCC.compile_expr(TCC.Xor(TCC.Var("a"), TCC.Var("b")))
    eng = TEngine(backend, **CPU)
    with pytest.raises(ValueError):
        eng.run_program(prog, {})
    with pytest.raises(ValueError):
        eng.run_program(prog, {"a": _planes(2, 8), "b": _planes(2, 16)})
    with pytest.raises(ValueError):
        eng.run_program(prog, {"a": _planes(2, 8)})
    assert eng.report.ops == 0          # a failed run meters nothing


@pytest.mark.parametrize("backend", ["torch", "kernel", "dram"])
def test_offload_report_meters(backend):
    eng = TEngine(backend, draws="numpy", **CPU)
    ref_eng = REngine(TWIN.get(backend, "dram"))
    p = _planes(8, 4, 64)
    for e in (eng, ref_eng):
        e.nary(p, "and")
        e.not_(p[0])
    rep = eng.report.summary()
    assert rep["ops"] == 2
    assert rep["dram_time_us"] > 0
    if backend != "dram":   # modeled, not measured with its host staging
        assert rep["energy_saving"] > 0.5        # the paper's motivation
        assert rep["bus_bytes_avoided"] > 0
    assert rep == ref_eng.report.summary()


def test_engine_config_and_defaults(monkeypatch):
    monkeypatch.delenv("FCDRAM_VERIFY", raising=False)
    assert EngineConfig().backend == "kernel"
    eng = TEngine(EngineConfig(backend="torch", seed=4), **CPU)
    assert eng.backend == "torch" and eng.seed == 4
    assert TEngine("dram", **CPU).config.resolved_resident() == "scheduled"
    assert EngineConfig().resolved_verify() is True     # pytest drives this
    assert EngineConfig(verify=False).resolved_verify() is False
    assert EngineConfig(verify=True).resolved_verify() is True
    with pytest.raises(ValueError):
        TEngine("jnp", **CPU)
    with pytest.raises(ValueError):
        TEngine("torch", banks=2, **CPU)


def test_engine_does_not_silently_run_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine()


# ---------------------------------------------------------------------------
# Engine: dram backend (numpy draws) vs the reference's dram backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("banks", [1, 2])
def test_dram_backend_equals_reference(banks):
    """Noisy, seed 3: 8-chunk planes (4 blocks of 2, dealt across the
    banks) and a 1-chunk plane (the scalar float64 sim), bit for bit, with
    the offload report equal field for field."""
    eng = TEngine("dram", noisy=True, seed=3, banks=banks, draws="numpy",
                  **CPU)
    ref_eng = REngine("dram", noisy=True, seed=3, banks=banks,
                      fused=False if banks > 1 else None)
    big, small = _planes(3, 4, 256), _planes(2, 1, 8)
    for p, op in ((big, "and"), (big, "nor"), (small, "nand")):
        assert _same(eng.nary(p, op), ref_eng.nary(p, op)), (op, p.shape)
    for p in (big[0], small[0]):
        assert _same(eng.not_(p), ref_eng.not_(p))
    assert eng.report.summary() == ref_eng.report.summary()
    assert sorted(eng.report.banks) == sorted(ref_eng.report.banks)
    for b in eng.report.banks:
        assert dataclasses.astuple(eng.report.bank(b).dram) == \
            dataclasses.astuple(ref_eng.report.bank(b).dram)
    assert dataclasses.astuple(eng.report.merged().dram) == \
        dataclasses.astuple(ref_eng.report.merged().dram)


def test_dram_ideal_agrees_with_torch():
    eng, twin = TEngine("dram", **CPU), TEngine("torch", **CPU)
    p = _planes(3, 1, 8)
    for op in ("and", "or", "nand", "nor"):
        assert torch.equal(eng.nary(p, op), twin.nary(p, op)), op
    assert torch.equal(eng.not_(p[0]), twin.not_(p[0]))


@pytest.mark.parametrize("call", ["run_program", "add", "fused",
                                  "schedule_timing"])
def test_dram_unported_paths_raise(call):
    """Only the fused multi-bank path (``fused.py``, ROADMAP A-3) still
    raises.  What needed the static analysis now runs: a resident plan
    under ``verify=True`` (run_program and add schedule one) and the
    rank-legal timing."""
    if call == "fused":
        with pytest.raises(NotImplementedError, match="A-3"):
            TEngine("dram", banks=2, fused=True, **CPU)
        return
    eng = TEngine("dram", verify=True, **CPU)
    a, b = _planes(2, 1, 8), _planes(2, 1, 8)
    if call == "run_program":
        prog = TCC.compile_expr(TCC.Xor(TCC.Var("a"), TCC.Var("b")))
        got = eng.run_program(prog, {"a": a[0], "b": b[0]})
        assert _same(got["out"], a[0] ^ b[0])
    elif call == "add":
        assert _same(eng.add(a, b),
                     TEngine("torch", **CPU).add(a, b))
    else:
        eng.add(a, b)
        tl = eng.schedule_timing()
        assert tl.relint() == 0 and tl.legal_makespan_ns > 0.0
        assert eng.report.legal_makespan_ns == tl.legal_makespan_ns


# ---------------------------------------------------------------------------
# Workloads: masks, routing, Bloom dedup, bit-serial dot
# ---------------------------------------------------------------------------
def test_mask_composition_matches_direct():
    s = 64
    doc = np.repeat([0, 1, 2, 3], 16)
    valid = np.asarray([True] * 60 + [False] * 4)
    got = TM.compose_attention_mask(TEngine("kernel", **CPU), s, window=8,
                                    doc_ids=doc, valid=valid)
    i = np.arange(s)
    want = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < 8)
    want &= doc[:, None] == doc[None, :]
    want &= valid[None, :]
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    import jax.numpy as jnp
    ref = RM.compose_attention_mask(REngine("pallas"), s, window=8,
                                    doc_ids=jnp.asarray(doc),
                                    valid=jnp.asarray(valid))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    for t, r in ((TM.causal_plane(s, "cpu"), RM.causal_plane(s)),
                 (TM.window_plane(s, 8, "cpu"), RM.window_plane(s, 8))):
        assert _same(t, r)


def test_route_mask_planes():
    gate_idx = RNG.integers(0, 8, (70, 2))
    planes = TM.route_mask_planes(TEngine("kernel", **CPU), gate_idx, 8)
    bits = tkops.unpack_bits(planes).numpy()[:, :70]
    for e in range(8):
        assert np.array_equal(bits[e].astype(bool),
                              (gate_idx == e).any(axis=1))
    import jax.numpy as jnp
    assert _same(planes, RM.route_mask_planes(
        REngine("pallas"), jnp.asarray(gate_idx), 8))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_bloom_filter_equals_reference(backend):
    eng = TEngine(backend, **CPU)
    bf_t = TBloom(m_bits=1 << 14, n_hashes=4, engine=eng, seed=2)
    bf_r = RBloom(m_bits=1 << 14, n_hashes=4, seed=2,
                  engine=REngine(TWIN[backend]))
    keys = RNG.integers(0, 2 ** 60, 400).astype(np.uint64)
    for lo in range(0, 400, 100):                # four insert batches
        bf_t.insert(keys[lo:lo + 100])
        bf_r.insert(keys[lo:lo + 100])
    assert _same(bf_t.plane, bf_r.plane)
    probe = np.concatenate([keys[:50], np.arange(3000, dtype=np.uint64)])
    assert np.array_equal(bf_t.probe(probe).numpy(), bf_r.probe(probe))
    assert np.array_equal(bf_t.contains(probe).numpy(),
                          bf_r.contains(probe))
    # no false negatives (both probe, so the reports stay comparable)
    assert bf_t.probe(keys).all() and bf_r.probe(keys).all()
    fresh = np.arange(10 ** 6, 10 ** 6 + 60, dtype=np.uint64)
    batch = np.concatenate([keys[:20], fresh])
    assert np.array_equal(bf_t.filter_new(batch).numpy(),
                          bf_r.filter_new(batch))
    assert _same(bf_t.plane, bf_r.plane)
    assert bf_t.fill_fraction == bf_r.fill_fraction
    assert eng.report.summary() == bf_r.engine.report.summary()


def test_bloom_empty_and_all_duplicate_batches():
    bf = TBloom(m_bits=1 << 12, n_hashes=3, engine=TEngine("torch", **CPU))
    bf.insert(np.zeros(0, dtype=np.uint64))
    assert bf.engine.report.ops == 0 and bf.fill_fraction == 0.0
    a = np.asarray([7, 8, 9], dtype=np.uint64)
    assert bf.filter_new(a).all()
    ops0 = bf.engine.report.ops
    assert not bf.filter_new(a).any()
    assert bf.engine.report.ops == ops0


@pytest.mark.parametrize("m,n,k", [(3, 4, 8), (5, 2, 40)])
def test_dot_bitserial_matches_popcount_gemm(m, n, k):
    x = RNG.integers(0, 2, (m, k), dtype=np.uint8)
    w = RNG.integers(0, 2, (n, k), dtype=np.uint8)
    eng = TEngine("kernel", **CPU)
    got = TW.dot_bitserial(x, w, eng)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert np.array_equal(got.numpy(),
                          np.asarray(rkops.popcount_gemm_bits(x, w)))
    assert np.array_equal(got.numpy(), RW.dot_bitserial(x, w))
    assert eng.report.ops == sum(
        v for op, v in TW.dot_program(k).stats().items()
        if op not in ("input", "const"))


def test_lane_packing_matches_reference():
    bits = RNG.integers(0, 2, 77, dtype=np.uint8)
    p = TW.pack_lanes(bits)
    assert _same(p, RW.pack_lanes(bits))
    assert np.array_equal(TW.unpack_lanes(p, 77).numpy(), bits)
    x = RNG.integers(0, 2, (3, 5), dtype=np.uint8)
    w = RNG.integers(0, 2, (4, 5), dtype=np.uint8)
    for got, want in zip(TW.dot_lane_planes(x, w), RW.dot_lane_planes(x, w),
                         strict=True):
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Import guard: every module of the port, no jax, no repro
# ---------------------------------------------------------------------------
def test_no_port_module_imports_jax_or_reference():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for need in ("repro_torch.pud.engine", "repro_torch.pud.masks",
                 "repro_torch.pud.bloom", "repro_torch.pud.workloads",
                 "repro_torch.core.compiler", "repro_torch.core.policy",
                 "repro_torch.kernels.bitwise",
                 "repro_torch.kernels.bitserial",
                 "repro_torch.kernels.popcount_gemm",
                 "repro_torch.models", "repro_torch.models.quant",
                 "repro_torch.convert", "repro_torch.analysis",
                 "repro_torch.analysis.verify", "repro_torch.analysis.timing",
                 "repro_torch.analysis.schedule",
                 "repro_torch.core.calibrate",
                 "repro_torch.core.reliability"):
        assert need in mods, need
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
