"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Two paths of the port run here.  The first is the paper's characterization
Monte-Carlo: trial-batched APAs on the torch ``BankSim`` through ``PudIsa``,
resolved by the hand-written sense-amp kernel, giving the success rates of
Fig. 15 (16-input AND/NAND/OR/NOR) and Fig. 7 (NOT) at the paper's scale —
10,000 trials per configuration on the native 8192-bit row.  The second is
the PuD engine's packed-plane path (``PudEngine("kernel")``): attention-mask
composition at S = 16384, MoE routing masks, Bloom-filter dedup over a
2**26-bit plane, the bit-serial adder and popcount over (1024, 1024)
planes and the bit-serial dot product, on the ``nary_bitwise`` /
``bitwise_not`` / ``add_planes`` / ``bitcount_planes`` kernels; and the
``dram`` backend, whose Boolean APAs resolve in the sense-amp kernel.  The
third is the binary dot product, computed two ways: as XNOR-popcount
binary linears at the projection widths of ``configs/qwen3_4b.py`` on the
``popcount_gemm`` kernel (forward, then STE training steps), and as
compiled AND + popcount programs executed on the simulated DRAM banks
(``dot_bitserial_tree``, the ``dram`` engine's ``run_program`` / ``add``,
the program-level Monte-Carlo), held against the kernel; ``maj3`` runs
through its entry point.
Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all started together);
3. each kernel against its plain PyTorch version on the card, bit for bit,
   at the main path's shapes, with its time beside its bound;
4. the Monte-Carlo path through ``charz.mc_boolean_success`` /
   ``mc_not_success``; the rates are held to the paper and to the
   closed-form model;
5. the engine path, workload by workload, each held to a direct torch
   computation on the card;
6. the engine's ``dram`` backend, ideal (equal to the ``kernel`` backend)
   and noisy (mismatches near the Fig. 15 failure rate);
7. ``draws="numpy"`` on the card against the same run on the CPU (equal),
   for the Monte-Carlo and for the ``dram`` engine;
8. the closed-form sampler on the card;
9. the binary linears (``quant_path``): up (9728 × 2560) and down
   (2560 × 9728) on 2048 tokens, the integer dots equal to the plain
   version bit for bit, then 5 STE SGD steps whose loss must fall;
10. the bank-executed programs (``program_path``): ``dot_bitserial_tree``
    (M = N = 128, K = 32, 4 banks) ideal equal to ``popcount_gemm_bits``
    on the kernel and noisy with its mismatch rate, the ``dram`` engine's
    ``run_program`` / ``add`` ideal equal to the ``kernel`` backend, the
    program Monte-Carlo (xor / maj3 / add4, host-staged and resident), and
    ``draws="numpy"`` card == CPU; then ``maj3`` through ``ops.maj3``.

Every path is driven with the launch counts set to 0 just before it and
read just after; a kernel of the path that was not launched fails the run.

Any failed check raises and the script exits non-zero.  The second-to-last
line is the kernel table as JSON; the last line is the device record.  With
no CUDA device, or without the repository's ``src/`` beside it, it exits
non-zero before printing a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
#: 32-bit operations outside the tensor cores (H100 SXM data sheet: the
#: float32 rate; the sheet gives no int32 logic rate, which is lower, so the
#: operation bound of the plane kernels is optimistic — they are bound by
#: bytes many times over either way)
OPS_PER_S = 67e12
#: dense int8 tensor-core rate (H100 SXM data sheet): the fastest exact
#: path the card has for the popcount GEMM, whose xnor product is a ±1
#: int8 product with int32 sums (2 operations per multiply-add) — its bound
INT8_OPS_PER_S = 1979e12
#: 32-bit population counts per clock per SM on compute capability 9.0
#: (CUDA C++ Programming Guide, arithmetic-instruction throughput table);
#: times the SM count and the card's max SM clock (read from nvidia-smi)
#: this is the ceiling of the CUDA-core design, printed beside the bound
POPC_PER_CLK_SM = 16
KERNEL_SOURCES = ("senseamp", "bitwise", "bitserial", "popcount_gemm")
#: the projection widths of src/repro/configs/qwen3_4b.py, on 2048 tokens
D_MODEL, D_FF, TOKENS = 2560, 9728, 2048
#: the reference's program-level MC success (BENCH_pr10.json, "Resident vs
#: host-staged program execution": staged_succ / resident_succ); the
#: 2-input NAND / AND / OR these programs compose fail often, so whole
#: programs land near 0.5-0.6
REF_PROGRAM_RATES = {"xor_host": 0.4933, "xor_scheduled": 0.5458,
                     "maj3_host": 0.5959, "maj3_scheduled": 0.5960,
                     "add4_host": 0.5023, "add4_scheduled": 0.5193}
PAPER_16 = {"and": 0.9494, "nand": 0.9494, "or": 0.9585, "nor": 0.9587}
PAPER_NOT1 = 0.9837
TRIALS, ROW_BITS = 10_000, 8192


def _phase(name: str, t0: float, times: dict) -> float:
    now = time.perf_counter()
    times[name] = round(now - t0, 3)
    print(f"[phase] {name}: {times[name]} s", flush=True)
    return now


def _time_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around ``reps`` back-to-back
    calls after a warm-up, over the count (the queue stays full, so the
    host's launch cost is hidden wherever the device is the slower side)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_senseamp(S) -> dict:
    """Gather kernel vs plain twin at the nand16 main-path shape."""
    tg = -(-TRIALS // 9)                 # trials per stratified pair group
    w, n, slots = ROW_BITS // 2, 16, 16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows_l = [int(r) for r in np.random.default_rng(0).permutation(slots)[:n]]
    rows_f = list(range(slots))[::-1][:n]
    normals = torch.randn((tg, w), generator=gen, device=dev)
    u0 = torch.rand((tg, w), generator=gen, device=dev)
    static = 0.02 * torch.randn((w,), generator=gen, device=dev)
    scal = dict(width=w, u_com=1 / 22, u_ref=1 / 22, sigma=0.0061, pf=0.0431,
                thr=0.0123)
    worst = 0
    cases = {}
    for kind in ("ternary", "float"):
        if kind == "ternary":
            cells = [torch.randint(0, 3, (tg, slots, ROW_BITS), generator=gen,
                                   device=dev).float() * 0.5
                     for _ in range(2)]
        else:
            cells = [torch.rand((tg, slots, ROW_BITS), generator=gen,
                                device=dev) for _ in range(2)]
        args = (cells[1], rows_l, w, cells[0], rows_f, 0)
        kw = dict(static=static, normals=normals, u0=u0, **scal)
        got = S.senseamp_gather_cuda(*args, **kw)
        want = S.senseamp_gather_plain(*args, **kw)
        torch.cuda.synchronize()
        diff = int((got.int() - want.int()).abs().max())
        worst = max(worst, diff)
        assert diff == 0, f"senseamp kernel != plain ({kind} cells)"
        cases[kind] = (args, kw)
    # scalar mode on the card: float64 draws cast to float32, two uniforms
    # per lane; plus a (T, W) static plane and ideal mode (no noise)
    g64 = torch.Generator(device=dev)
    g64.manual_seed(99)
    args = cases["ternary"][0]
    one = tuple(x[:1] if torch.is_tensor(x) else x for x in args)
    extra = {
        "scalar": (one, dict(static=static.double().float(),
                             normals=torch.randn((1, w), generator=g64,
                                                 device=dev,
                                                 dtype=torch.float64).float(),
                             u0=torch.rand((1, w), generator=g64, device=dev,
                                           dtype=torch.float64).float(),
                             u1=torch.rand((1, w), generator=g64, device=dev,
                                           dtype=torch.float64).float(),
                             **scal)),
        "static_plane": (args, dict(cases["ternary"][1],
                                    static=0.02 * torch.randn(
                                        (tg, w), generator=gen, device=dev))),
        "ideal": (args, dict(width=w, u_com=1 / 22, u_ref=1 / 22)),
    }
    for kind, (a, kw) in extra.items():
        got = S.senseamp_gather_cuda(*a, **kw)
        want = S.senseamp_gather_plain(*a, **kw)
        diff = int((got.int() - want.int()).abs().max())
        worst = max(worst, diff)
        assert diff == 0, f"senseamp kernel != plain ({kind})"
    # the slab front end (identity slots) on the card == on the CPU
    from repro_torch.kernels import ops
    t, nn = 64, 5
    slab = dict(u_com=.09, u_ref=.11, shift=.015, pf=.03, trial_sigma=.01)
    ins = [torch.rand((t, nn, w), generator=gen, device=dev),
           torch.rand((t, nn + 2, w), generator=gen, device=dev),
           0.02 * torch.randn((w,), generator=gen, device=dev),
           torch.randn((t, w), generator=gen, device=dev),
           torch.rand((2, t, w), generator=gen, device=dev)]
    before = S.launches
    got = ops.senseamp_resolve_trials(*ins, **slab)
    assert S.launches == before + 1
    want = ops.senseamp_resolve_trials(*(x.cpu() for x in ins), **slab)
    diff = int((got.cpu().int() - want.int()).abs().max())
    worst = max(worst, diff)
    assert diff == 0, "senseamp_resolve_trials: card != CPU"
    args, kw = cases["ternary"]
    ms = _time_ms(lambda: S.senseamp_gather_cuda(*args, **kw))
    plain_ms = _time_ms(lambda: S.senseamp_gather_plain(*args, **kw), reps=5)
    # bytes the function must move: each activated cell, the normal, the
    # uniform and the static offsets read once, each output bit written once
    nbytes = tg * w * (4 * (len(rows_l) + len(rows_f)) + 4 + 4 + 1) + 4 * w
    return {"name": "senseamp_resolve", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/senseamp.cu",
            "replaces": "src/repro/kernels/senseamp.py:77",
            "launches": None, "max_abs_err": float(worst),
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
            "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 6),
            "bound_by": "bytes", "library_ms": None,
            "shape": {"T": tg, "W": w, "n_com": n, "n_ref": n}}


def _bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time the card could take (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _words(gen, *shape) -> torch.Tensor:
    """Random packed words (int32 bit patterns) on the card."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int64, device="cuda").to(torch.int32)


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |kernel - plain| over the words, as integers."""
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def check_bitkernels(BW, BS) -> list[dict]:
    """The four plane kernels vs their plain twins, bit for bit: every op,
    N = 1 and 17, ragged and unaligned lengths, then the main path's shapes
    (timed).  -> one JSON row per kernel (launches filled in later)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    worst = {"nary_bitwise": 0, "bitwise_not": 0, "add_planes": 0,
             "bitcount_planes": 0, "maj3": 0}

    def held(name, got, want, what):
        d = _diff(got, want)
        worst[name] = max(worst[name], d)
        assert d == 0, f"{name} kernel != plain ({what})"

    for shape in ((1, 64, 512), (17, 64, 512), (3, 7, 1000), (2, 1, 4097)):
        p = _words(gen, *shape)
        for op in BW.OPS:
            held("nary_bitwise", BW.nary_bitwise_cuda(p, op),
                 BW.nary_bitwise_plain(p, op), (op, shape))
    for shape in ((7, 1000), (1, 3)):
        p = _words(gen, *shape)
        held("bitwise_not", BW.bitwise_not_cuda(p), BW.bitwise_not_plain(p),
             shape)
    for shape in ((7, 1000), (1, 3), (3, 70)):
        abc = [_words(gen, *shape) for _ in range(3)]
        held("maj3", BW.maj3_cuda(*abc), BW.maj3_plain(*abc), shape)
    abc = [_words(gen, 1, 4101)[:, 1:] for _ in range(3)]   # unaligned
    held("maj3", BW.maj3_cuda(*(x.contiguous() for x in abc)),
         BW.maj3_plain(*abc), "unaligned")
    for k, shape in ((1, (7, 1000)), (5, (3, 70))):
        a, b = _words(gen, k, *shape), _words(gen, k, *shape)
        held("add_planes", BS.add_planes_cuda(a, b),
             BS.add_planes_plain(a, b), (k, shape))
    for n, shape in ((1, (7, 1000)), (17, (3, 70)), (255, (2, 36))):
        p = _words(gen, n, *shape)
        held("bitcount_planes", BS.bitcount_planes_cuda(p),
             BS.bitcount_planes_plain(p), (n, shape))

    def timed(name, cuda_fn, plain_fn, args, nbytes, nops, library=None):
        held(name, cuda_fn(*args), plain_fn(*args), "main-path shape")
        bound, by = _bound(nbytes, nops)
        return {"ms": round(_time_ms(lambda: cuda_fn(*args)), 6),
                "plain_ms": round(_time_ms(lambda: plain_fn(*args), reps=5),
                                  6),
                "bound_ms": round(bound, 6), "bound_by": by,
                "library_ms": (None if library is None else
                               round(_time_ms(lambda: library(*args)), 6))}

    mask = _words(gen, 4, 16384, 512)             # the attention-mask stack
    words = 16384 * 512
    t_mask = timed("nary_bitwise", BW.nary_bitwise_cuda,
                   BW.nary_bitwise_plain, (mask, "and"), 4 * 5 * words,
                   3 * words)
    del mask
    bloom = _words(gen, 5, 1, 2 ** 21)            # the Bloom insert stack
    t_bloom = timed("nary_bitwise", BW.nary_bitwise_cuda,
                    BW.nary_bitwise_plain, (bloom, "or"), 4 * 6 * 2 ** 21,
                    4 * 2 ** 21)
    del bloom
    plane = _words(gen, 16384, 512)
    t_not = timed("bitwise_not", BW.bitwise_not_cuda, BW.bitwise_not_plain,
                  (plane,), 4 * 2 * words, words, library=torch.bitwise_not)
    abc = [plane, _words(gen, 16384, 512), _words(gen, 16384, 512)]
    t_maj = timed("maj3", BW.maj3_cuda, BW.maj3_plain, abc, 4 * 4 * words,
                  4 * words)
    del plane, abc
    words = 1024 * 1024
    a, b = _words(gen, 16, 1024, 1024), _words(gen, 16, 1024, 1024)
    t_add = timed("add_planes", BS.add_planes_cuda, BS.add_planes_plain,
                  (a, b), 4 * (16 + 16 + 17) * words, 5 * 16 * words)
    del b
    k = BS.slices_for(16)
    t_cnt = timed("bitcount_planes", BS.bitcount_planes_cuda,
                  BS.bitcount_planes_plain, (a,), 4 * (16 + k) * words,
                  2 * k * 16 * words)
    del a
    torch.cuda.synchronize()
    src = "src/repro_torch/kernels/csrc/"
    rows = [
        dict(name="nary_bitwise", source=src + "bitwise.cu",
             replaces="src/repro/kernels/bitwise.py:59", **t_mask,
             shape={"N": 4, "R": 16384, "C": 512, "op": "and"},
             bloom_shape={"N": 5, "R": 1, "C": 2 ** 21, "op": "or",
                          **t_bloom}),
        dict(name="bitwise_not", source=src + "bitwise.cu",
             replaces="src/repro/kernels/bitwise.py:84", **t_not,
             shape={"R": 16384, "C": 512}),
        dict(name="maj3", source=src + "bitwise.cu",
             replaces="src/repro/kernels/bitwise.py:110", **t_maj,
             shape={"R": 16384, "C": 512}),
        dict(name="add_planes", source=src + "bitserial.cu",
             replaces="src/repro/kernels/bitserial.py:47", **t_add,
             shape={"K": 16, "R": 1024, "C": 1024}),
        dict(name="bitcount_planes", source=src + "bitserial.cu",
             replaces="src/repro/kernels/bitserial.py:82", **t_cnt,
             shape={"N": 16, "R": 1024, "C": 1024}),
    ]
    return [{"route": "cuda", "launches": None,
             "max_abs_err": float(worst[r["name"]]), **r} for r in rows]


def _pm1_bf16(words: torch.Tensor, k: int) -> torch.Tensor:
    """Packed words (rows, KB) -> the ±1 values of their first k bits as
    bfloat16 (rows, k): the operands of the library yardstick."""
    from repro_torch.kernels.ops import unpack_bits
    return (2 * unpack_bits(words)[:, :k].to(torch.bfloat16) - 1)


def check_popcount_gemm(PG, clock_mhz: float) -> dict:
    """The binary GEMM vs its plain twin, bit for bit: both kinds at
    ragged shapes (130 x 50 x 65 is the reference's padded-and-corrected
    case) and at the two serve shapes of the quant path, xnor timed there.
    Bound: the same product as ±1 int8 on the tensor cores, 2·M·N·32·KB
    operations at the dense int8 rate (the bytes bound is smaller);
    ``popc_bound_ms`` is the CUDA-core design's own ceiling, one POPC per
    (m, n, word) at 16 per clock per SM.  Library yardstick: ``torch.mm``
    on the same operands unpacked to ±1 bfloat16 — a time only; its output
    is rounded bfloat16, not the same value."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1313)
    worst = 0
    shapes = ((8, 8, 2), (130, 50, 65), (1, 1, 1), (300, 257, 80),
              (64, 64, 32), (77, 3, 304))
    serve = {"up": (TOKENS, D_FF, D_MODEL // 32),
             "down": (TOKENS, D_MODEL, D_FF // 32)}
    for m, n, kb in (*shapes, *serve.values()):
        x, w = _words(gen, m, kb), _words(gen, n, kb)
        for kind in PG.KINDS:
            d = _diff(PG.popcount_gemm_cuda(x, w, kind),
                      PG.popcount_gemm_plain(x, w, kind))
            worst = max(worst, d)
            assert d == 0, f"popcount_gemm kernel != plain {(m, n, kb)}"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popc_per_s = POPC_PER_CLK_SM * sms * clock_mhz * 1e6
    timing = {}
    for name, (m, n, kb) in serve.items():
        x, w = _words(gen, m, kb), _words(gen, n, kb)
        nbytes = 4 * (m * kb + n * kb + m * n)
        t_ops = 2 * m * n * 32 * kb / INT8_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        xb, wb = _pm1_bf16(x, 32 * kb), _pm1_bf16(w, 32 * kb)
        timing[name] = {
            "ms": round(_time_ms(
                lambda: PG.popcount_gemm_cuda(x, w, "xnor")), 6),
            "plain_ms": round(_time_ms(
                lambda: PG.popcount_gemm_plain(x, w, "xnor"), reps=5), 6),
            "bound_ms": round(max(t_ops, t_bytes), 6),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "popc_bound_ms": round(m * n * kb / popc_per_s * 1e3, 6),
            "library_ms": round(_time_ms(lambda: torch.mm(xb, wb.T)), 6),
            "shape": {"M": m, "N": n, "KB": kb, "kind": "xnor"}}
        del xb, wb
    up = timing.pop("up")
    return {"name": "popcount_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/popcount_gemm.cu",
            "replaces": "src/repro/kernels/popcount_gemm.py:73",
            "launches": None, "max_abs_err": float(worst), **up,
            "down_shape": timing["down"],
            "bound_rate": {"int8_ops_per_s": INT8_OPS_PER_S,
                           "popc_per_clk_sm": POPC_PER_CLK_SM, "sms": sms,
                           "max_sm_clock_mhz": clock_mhz}}


class Counts:
    """The launch counters of every kernel, reset and read per path, and
    each path's wall time (host clock from the reset to the synchronize
    of the read)."""

    def __init__(self, S, BW, BS, PG):
        self.S, self.dicts = S, (BW.launches, BS.launches, PG.launches)
        self.by_path: dict[str, dict[str, int]] = {}
        self.wall_s: dict[str, float] = {}
        self._t0 = 0.0

    def reset(self) -> None:
        self.S.launches = 0
        for d in self.dicts:
            for k in d:
                d[k] = 0
        self._t0 = time.perf_counter()

    def read(self, path: str) -> dict[str, int]:
        torch.cuda.synchronize()
        self.wall_s[path] = time.perf_counter() - self._t0
        c = {"senseamp_resolve": self.S.launches}
        for d in self.dicts:
            c.update(d)
        self.by_path[path] = c
        print(f"[launches] {path}: {json.dumps(c)} in "
              f"{self.wall_s[path]} s", flush=True)
        return c

    def total(self, name: str) -> int:
        return sum(c[name] for c in self.by_path.values())


def _values(planes: torch.Tensor) -> torch.Tensor:
    """(K, R, C) LSB-first planes -> the (R, 32C) integers they slice."""
    from repro_torch.kernels.ops import unpack_bits
    out = None
    for i in range(planes.shape[0]):
        v = unpack_bits(planes[i]).long() << i
        out = v if out is None else out + v
    return out


def engine_path(counts: Counts) -> dict:
    """The PuD engine's plane path on ``PudEngine("kernel")``, workload by
    workload, each held to a direct computation on the card."""
    from repro_torch.kernels.ops import unpack_bits
    from repro_torch.pud import masks as M
    from repro_torch.pud import workloads as W
    from repro_torch.pud.bloom import PudBloomFilter
    from repro_torch.pud.engine import PudEngine
    dev = torch.device("cuda")
    eng = PudEngine("kernel", device="cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    only = lambda c, **want: all(c[k] == want.get(k, 0) for k in c)
    out: dict = {}

    # attention mask: causal & window 4096 & 8 documents & last 1024 padded
    s, window = 16384, 4096
    i = torch.arange(s, device=dev)
    doc, valid = i // (s // 8), i < s - 1024
    counts.reset()
    got = M.compose_attention_mask(eng, s, window=window, doc_ids=doc,
                                   valid=valid)
    c = counts.read("engine_masks")
    assert only(c, nary_bitwise=1), c
    want = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    want &= doc[:, None] == doc[None, :]
    want &= valid[None, :]
    assert torch.equal(got, want), "attention mask != direct"
    out["mask_keep_fraction"] = float(got.float().mean())
    del got, want
    # the positions an additive attention bias blocks: NOT of the causal plane
    causal = M.causal_plane(s, dev)
    counts.reset()
    blocked = eng.not_(causal)
    c = counts.read("engine_not")
    assert only(c, bitwise_not=1), c
    assert torch.equal(unpack_bits(blocked).bool(), i[:, None] < i[None, :]), \
        "NOT of the causal plane != the future positions"
    del causal, blocked

    # MoE routing: 32768 tokens, top-4 of 60 experts (qwen2_moe_a2_7b)
    t, e, k = 32768, 60, 4
    gate = torch.randn((t, e), generator=gen, device=dev).topk(k, 1).indices
    counts.reset()
    planes = M.route_mask_planes(eng, gate, e)
    c = counts.read("engine_routing")
    assert only(c, nary_bitwise=1), c
    bits = unpack_bits(planes)[:, :t].bool()
    want = (gate[None] == torch.arange(e, device=dev)[:, None, None]).any(2)
    assert torch.equal(bits, want), "routing planes != (gate == e).any(1)"

    # Bloom dedup: 2**26 bits, 4 hashes, 4M keys in 8 batches, 1M probes
    m_bits, n_hashes, batch = 2 ** 26, 4, 2 ** 19
    keys = np.arange(8 * batch, dtype=np.uint64)
    fresh = np.arange(2 ** 40, 2 ** 40 + 2 ** 20, dtype=np.uint64)
    bf = PudBloomFilter(m_bits, n_hashes, engine=eng)
    counts.reset()
    for lo in range(0, len(keys), batch):
        bf.insert(keys[lo:lo + batch])
    present = bf.probe(keys)
    fp = float(bf.probe(fresh).float().mean())
    c = counts.read("engine_bloom")
    assert only(c, nary_bitwise=8 + 2), c
    assert bool(present.all()), "an inserted key was reported absent"
    theory = (1 - np.exp(-n_hashes * len(keys) / m_bits)) ** n_hashes
    print(f"[bloom] false-positive rate {fp} theory {theory} fill "
          f"{bf.fill_fraction}", flush=True)
    assert 0.5 * theory <= fp <= 2.0 * theory, (fp, theory)
    out["bloom_fp_rate"], out["bloom_fp_theory"] = fp, float(theory)

    # bit-serial add (K = 16) and popcount (16 planes) over (1024, 1024)
    a = _words(gen, 16, 1024, 1024)
    b = _words(gen, 16, 1024, 1024)
    counts.reset()
    total = eng.add(a, b)
    c = counts.read("engine_add")
    assert only(c, add_planes=1), c
    assert torch.equal(_values(total), _values(a) + _values(b)), "add"
    del total, b
    counts.reset()
    cnt = eng.popcount(a)
    c = counts.read("engine_popcount")
    assert only(c, bitcount_planes=1), c
    per_bit = sum(unpack_bits(a[j]).long() for j in range(a.shape[0]))
    assert torch.equal(_values(cnt), per_bit), "popcount"
    del cnt, a, per_bit

    # bit-serial dot product: M = N = 64, K = 256
    x = torch.randint(0, 2, (64, 256), generator=gen, device=dev)
    w = torch.randint(0, 2, (64, 256), generator=gen, device=dev)
    n_instr = sum(v for op, v in W.dot_program(256).stats().items()
                  if op not in ("input", "const"))
    counts.reset()
    y = W.dot_bitserial(x, w, eng)
    c = counts.read("engine_dot")
    assert c["nary_bitwise"] + c["bitwise_not"] == n_instr, (c, n_instr)
    assert only(c, nary_bitwise=c["nary_bitwise"],
                bitwise_not=c["bitwise_not"]), c
    assert torch.equal(y.cpu().long(), x.cpu() @ w.cpu().T), "dot"
    out["dot_instructions"] = n_instr
    out["report"] = eng.report.summary()
    return out


def dram_path(counts: Counts, and16: float) -> dict:
    """The engine's dram backend on the card: 16-plane AND over (128, 1024)
    planes — 1024 row chunks of 4096 bits in 32 blocks, one senseamp launch
    each.  Ideal: equal to the kernel backend, on planes that share half
    their bits (so the AND keeps about half).  Noisy: on uniformly random
    planes, the operand patterns of Fig. 15's Monte-Carlo, the mismatches
    land near its failure rate."""
    from repro_torch.kernels.ops import nary_bitwise, unpack_bits
    from repro_torch.pud.engine import PudEngine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    shared = _words(gen, 1, 128, 1024) | _words(gen, 16, 128, 1024)
    blocks = 32
    out = {}
    for noisy, planes in ((False, shared),
                          (True, _words(gen, 16, 128, 1024))):
        want = nary_bitwise(planes, "and")
        eng = PudEngine("dram", noisy=noisy, device="cuda")
        path = "dram_noisy" if noisy else "dram_ideal"
        counts.reset()
        got = eng.nary(planes, "and")
        c = counts.read(path)
        assert c["senseamp_resolve"] == blocks, c
        assert sum(c.values()) == blocks, c
        wrong = float(unpack_bits(got ^ want).float().mean())
        if noisy:
            print(f"[dram] noisy and16 mismatch fraction {wrong}; "
                  f"1 - Fig. 15 and16 rate {1 - and16}", flush=True)
            assert 0.0 < wrong < 0.15, wrong
            out["noisy_mismatch"] = wrong
        else:
            assert wrong == 0.0, "dram (ideal) != kernel backend"
            out["ideal_ones_fraction"] = float(
                unpack_bits(got).float().mean())
    return out


def quant_path(counts: Counts) -> dict:
    """Binary linears at qwen3_4b's projection widths on 2048 tokens: up
    (2560 -> 9728) then down (9728 -> 2560), one popcount_gemm each; the
    integer dots held to the plain version bit for bit, the outputs within
    1e-6 relative; then 5 STE SGD steps of the up layer against a
    sign-teacher target (float32 products: TF32 off), the loss falling at
    every step."""
    from repro_torch.kernels import popcount_gemm as PG
    from repro_torch.models import quant as Q
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4096)
    up = Q.BinaryLinear(D_MODEL, D_FF, generator=gen, device="cuda")
    down = Q.BinaryLinear(D_FF, D_MODEL, generator=gen, device="cuda")
    x = torch.randn((TOKENS, D_MODEL), generator=gen, device="cuda")
    only = lambda c, **want: all(c[k] == want.get(k, 0) for k in c)
    with torch.no_grad():
        counts.reset()
        h = up(x)
        y = down(h)
        c = counts.read("quant_path")
    assert only(c, popcount_gemm=2), c
    t1 = time.perf_counter()
    walls["setup_and_forward_s"] = t1 - t0
    assert y.shape == (TOKENS, D_MODEL) and bool(torch.isfinite(y).all())
    worst_rel = 0.0
    for layer, inp, out in ((up, x, h), (down, h, y)):
        xq, sx = Q.binarize_pack(inp)
        wq, sw = Q.binarize_pack(layer.weight.detach())
        dots = PG.popcount_gemm_cuda(xq, wq, "xnor")
        plain = PG.popcount_gemm_plain(xq, wq, "xnor")
        assert torch.equal(dots, plain), "binary linear dots != plain"
        pad = (-inp.shape[1]) % 32
        want = (plain.float() - pad) * sx * sw.T
        rel = float((out - want).abs().max() / want.abs().max())
        worst_rel = max(worst_rel, rel)
        assert rel <= 1e-6, rel
    del h, y
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    walls["check_vs_plain_s"] = t2 - t1
    # STE training: 5 SGD steps against a sign teacher (unit-variance y);
    # the set-up timed piece by piece (host clock, synchronized)
    def lap(name: str) -> None:
        nonlocal t2
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls[name] = now - t2
        t2 = now

    teacher = torch.sign(torch.randn((D_FF, D_MODEL), generator=gen,
                                     device="cuda"))
    target = x @ teacher.T / D_MODEL ** 0.5
    lap("teacher_and_target_s")
    # torch.optim imports torch._dynamo lazily on an optimizer's first
    # construction in a process: that import is this lap
    dynamo_before = "torch._dynamo" in sys.modules
    opt = torch.optim.SGD(up.parameters(), lr=10.0)
    lap("optimizer_init_s")
    walls["optimizer_init_imported_dynamo"] = (
        not dynamo_before and "torch._dynamo" in sys.modules)
    losses = []
    counts.reset()
    for _ in range(5):
        opt.zero_grad()
        loss = ((up(x) - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        losses.append(float(((up(x) - target) ** 2).mean()))
    c = counts.read("quant_train")
    assert only(c, popcount_gemm=6), c
    lap("train_s")
    print(f"[quant] STE losses {losses}", flush=True)
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    return {"max_rel_err": worst_rel, "ste_losses": losses, "walls": walls}


def program_path(counts: Counts) -> dict:
    """The binary dot product as compiled programs on the simulated banks
    (native 8192-bit rows), held against the popcount GEMM kernel and the
    ``kernel`` backend; the program Monte-Carlo; numpy-draw parity."""
    from repro_torch.core import charz
    from repro_torch.core.policy import ResidentPolicy
    from repro_torch.kernels import ops
    from repro_torch.pud import workloads as W
    from repro_torch.pud.engine import PudEngine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(808)
    out: dict = {}
    only_sa = lambda c: c["senseamp_resolve"] > 0 and sum(c.values()) == \
        c["senseamp_resolve"]
    # dot_bitserial_tree: M = N = 128, K = 32 over 4 banks
    x = torch.randint(0, 2, (128, 32), generator=gen, device="cuda")
    w = torch.randint(0, 2, (128, 32), generator=gen, device="cuda")
    for noisy in (False, True):
        path = "program_tree_noisy" if noisy else "program_tree"
        counts.reset()
        got, arr = W.dot_bitserial_tree(x, w, banks=4, noisy=noisy,
                                        device="cuda")
        c = counts.read(path)
        assert only_sa(c), c
        counts.reset()
        want = ops.popcount_gemm_bits(x, w)
        c = counts.read(path + "_golden")
        assert c["popcount_gemm"] == 1 and sum(c.values()) == 1, c
        assert torch.equal(want.cpu().long(), x.cpu() @ w.cpu().T)
        if noisy:
            rate = float((got != want).float().mean())
            print(f"[program] dot_bitserial_tree noisy: {rate} of the "
                  f"(128, 128) counts differ from the kernel", flush=True)
            assert 0.0 < rate <= 1.0, rate
            out["tree_noisy_mismatch"] = rate
        else:
            assert torch.equal(got, want), "dot_bitserial_tree != kernel"
            out["tree_makespan_ns"] = arr.makespan_ns()
    # the dram engine, 4 banks: the dot program over (16, 1024) planes
    # (128 row chunks in 4 blocks of 32) and an 8-bit add
    prog = W.dot_program(8)
    planes = {f"{s}{i}": _words(gen, 16, 1024) for s in "ab"
              for i in range(8)}
    a, b = _words(gen, 8, 16, 1024), _words(gen, 8, 16, 1024)
    eng = PudEngine("dram", banks=4, device="cuda")
    counts.reset()
    got = eng.run_program(prog, planes)
    total = eng.add(a, b)
    c = counts.read("program_engine")
    assert only_sa(c), c
    kern = PudEngine("kernel", device="cuda")
    want = kern.run_program(prog, planes)
    assert all(torch.equal(got[k], want[k]) for k in want), "dram != kernel"
    assert torch.equal(total, kern.add(a, b)), "dram add != kernel"
    out["engine_report"] = eng.report.summary()
    # program-level Monte-Carlo, host-staged and scheduled-resident
    rates = {}
    counts.reset()
    for name in charz.PROGRAMS:
        for pol in (ResidentPolicy.HOST, ResidentPolicy.SCHEDULED):
            rates[f"{name}_{pol.value}"] = charz.mc_program_success(
                name, trials=2000, row_bits=8192, resident=pol,
                device="cuda")
    c = counts.read("program_mc")
    assert only_sa(c), c
    print("[program] mc_program_success " + json.dumps(rates) + " reference "
          + json.dumps(REF_PROGRAM_RATES), flush=True)
    for k, r in rates.items():
        assert abs(r - REF_PROGRAM_RATES[k]) < 0.02, (k, r)
    out["mc_rates"] = rates
    # numpy draws: card == CPU (program MC, resident, and the noisy tree)
    par = {dev: (charz.mc_program_success(
        "add4", trials=18, row_bits=512, resident=ResidentPolicy.SCHEDULED,
        draws="numpy", device=dev),
        W.dot_bitserial_tree(x[:4, :9].cpu(), w[:5, :9].cpu(), banks=3,
                             row_bits=2048, noisy=True, draws="numpy",
                             device=dev)[0].cpu())
        for dev in ("cuda", "cpu")}
    assert par["cuda"][0] == par["cpu"][0], par
    assert torch.equal(par["cuda"][1], par["cpu"][1]), "tree: card != CPU"
    print(f"[parity] program MC + noisy tree, draws=numpy: cuda == cpu "
          f"({par['cuda'][0]})", flush=True)
    return out


def maj3_path(counts: Counts) -> None:
    """``ops.maj3``, the reference's entry point of its own, once at the
    (16384, 512) shape, held to the direct computation."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(333)
    a, b, c3 = (_words(gen, 16384, 512) for _ in range(3))
    counts.reset()
    got = ops.maj3(a, b, c3)
    c = counts.read("maj3_entry")
    assert c["maj3"] == 1 and sum(c.values()) == 1, c
    assert torch.equal(got, (a & b) | (c3 & (a | b))), "maj3 != direct"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import analog as A
    from repro_torch.core import analog_torch as AT
    from repro_torch.core import charz
    from repro_torch.kernels import bitserial as BS
    from repro_torch.kernels import bitwise as BW
    from repro_torch.kernels import build
    from repro_torch.kernels import popcount_gemm as PG
    from repro_torch.kernels import senseamp as S
    from repro_torch.pud.engine import PudEngine

    times: dict[str, float] = {}
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(f"[card] max SM clock {clock} MHz", flush=True)
    t0 = _phase("nvidia_smi", t0, times)

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(build.load, KERNEL_SOURCES))
    t0 = _phase("build", t0, times)

    row = check_senseamp(S)
    print(f"[senseamp] kernel == plain bit for bit; kernel {row['ms']} ms, "
          f"plain {row['plain_ms']} ms, bound {row['bound_ms']} ms "
          f"({row['bound_by']}) at {row['shape']}", flush=True)
    bit_rows = check_bitkernels(BW, BS)
    bit_rows.append(check_popcount_gemm(PG, clock))
    for r in bit_rows:
        print(f"[{r['name']}] kernel == plain bit for bit; kernel {r['ms']} "
              f"ms, plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']}) at {r['shape']}",
              flush=True)
    print("[popcount_gemm] down shape "
          + json.dumps(bit_rows[-1]["down_shape"]), flush=True)
    t0 = _phase("kernel_vs_plain", t0, times)

    # ---- main path: the launch count covers exactly these calls ----
    counts = Counts(S, BW, BS, PG)
    counts.reset()
    rates, peak = {}, {}
    for op in charz.OPS:
        for n in charz.NS:
            before = S.launches
            torch.cuda.reset_peak_memory_stats()
            r = charz.mc_boolean_success(op, n, trials=TRIALS,
                                         row_bits=ROW_BITS, device="cuda")
            peak[f"{op}{n}"] = torch.cuda.max_memory_allocated()
            rates[f"{op}{n}"] = r
            assert S.launches - before == charz.MC_PAIR_GROUPS, \
                (op, n, S.launches - before)
    for d in charz.NOT_DSTS:
        torch.cuda.reset_peak_memory_stats()
        rates[f"not{d}"] = charz.mc_not_success(d, trials=TRIALS,
                                                row_bits=ROW_BITS,
                                                device="cuda")
        peak[f"not{d}"] = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    mc = counts.read("mc")
    t0 = _phase("main_path", t0, times)
    assert mc["senseamp_resolve"] > 0
    for op, paper in PAPER_16.items():
        got = rates[f"{op}16"]
        closed = float(np.mean(A.boolean_success_avg_grid(
            op, 16, die_rev="M", density_gb=4)))
        print(f"[fig15] {op}16 mc {got} paper {paper} closed {closed}",
              flush=True)
        assert abs(got - paper) < 0.04, (op, got, paper)
        assert abs(got - closed) < 0.015, (op, got, closed)
        assert got > rates[f"{op}2"], (op, got, rates[f"{op}2"])
    print(f"[fig7] not1 mc {rates['not1']} paper {PAPER_NOT1}; not32 mc "
          f"{rates['not32']}", flush=True)
    assert abs(rates["not1"] - PAPER_NOT1) < 0.05
    assert rates["not32"] < 0.35
    print("[rates] " + json.dumps(rates), flush=True)
    print("[peak_bytes] " + json.dumps(peak), flush=True)

    # ---- the engine's plane path, then its dram backend ----
    eng_out = engine_path(counts)
    print("[engine] " + json.dumps(eng_out), flush=True)
    t0 = _phase("engine_path", t0, times)
    dram_out = dram_path(counts, rates["and16"])
    t0 = _phase("dram_path", t0, times)

    # ---- the numpy-draw parity mode: card == CPU ----
    par = {}
    for name, fn in (("nand16", lambda dev: charz.mc_boolean_success(
                         "nand", 16, trials=108, row_bits=2048,
                         draws="numpy", device=dev)),
                     ("not1", lambda dev: charz.mc_not_success(
                         1, trials=108, row_bits=2048, draws="numpy",
                         device=dev))):
        par[name] = (fn("cuda"), fn("cpu"))
        assert par[name][0] == par[name][1], (name, par[name])
    print(f"[parity] draws=numpy cuda == cpu: {par}", flush=True)
    # the dram engine: 8-chunk planes (4 batched blocks), noisy, numpy draws
    words = np.random.default_rng(5).integers(0, 2 ** 32, (3, 4, 256),
                                              dtype=np.uint32)
    got = {}
    for dev in ("cuda", "cpu"):
        eng = PudEngine("dram", noisy=True, seed=3, draws="numpy",
                        device=dev)
        got[dev] = [eng.nary(words, "nand").cpu(), eng.not_(words[0]).cpu(),
                    eng.report.summary()]
    assert all(torch.equal(x, y) for x, y in zip(got["cuda"][:2],
                                                 got["cpu"][:2])), \
        "dram engine: card != CPU"
    assert got["cuda"][2] == got["cpu"][2]
    print("[parity] dram engine nand + not, draws=numpy: cuda == cpu",
          flush=True)
    t0 = _phase("cross_device_parity", t0, times)

    sampled = AT.sample_boolean_success("and", 16, trials=TRIALS, width=4096,
                                        device="cuda")
    closed = A.boolean_success_avg("and", 16)
    assert abs(sampled - closed) < 0.01, (sampled, closed)
    print(f"[sampler] and16 sampled {sampled} closed {closed}", flush=True)
    t0 = _phase("sampler", t0, times)

    # ---- the binary dot product: binary linears, then bank programs ----
    quant_out = quant_path(counts)
    print("[quant] " + json.dumps(quant_out), flush=True)
    t0 = _phase("quant_path", t0, times)
    prog_out = program_path(counts)
    print("[program] " + json.dumps(prog_out), flush=True)
    maj3_path(counts)
    t0 = _phase("program_path", t0, times)
    print("[times] " + json.dumps(times), flush=True)

    rows = [row, *bit_rows]
    for r in rows:
        r["launches"] = counts.total(r["name"])
        r["launches_by_path"] = {p: c[r["name"]]
                                 for p, c in counts.by_path.items()
                                 if c[r["name"]]}
        assert r["launches"] > 0, r["name"]
    print("[dram] " + json.dumps(dram_out), flush=True)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
